"""Bird's-eye perspective calibration tool (numpy only).

Copied from lane_tracker_tpu/calib/perspective.py (``calibrate_warp`` :22,
``reference_warp_calibration`` :57); tests/test_torch_host.py pins both
equal to the originals.  The reference's interactive notebook workflow
(perspective_transformation.ipynb cells 6-13): choose four source points
on an undistorted straight-road frame and a destination rectangle, solve
the homography both ways, pick the warped canvas size, and derive the
meters-per-pixel conversion from a patch of known real-world size (lane
width 3.66 m, dash spacing 3.05 m on US highways).
"""

from __future__ import annotations

import numpy as np

from lane_tracker_tpu_torch.calib.homography import get_perspective_transform
from lane_tracker_tpu_torch.calib.io import WarpParams

US_LANE_WIDTH_M = 3.66
US_DASH_SPACING_M = 3.05


def calibrate_warp(
    src_points,
    dst_points,
    image_size,
    warped_size,
    patch_width_px,
    patch_height_px,
    patch_width_m=US_LANE_WIDTH_M,
    patch_height_m=US_DASH_SPACING_M,
) -> WarpParams:
    """Build WarpParams from a source trapezoid and metric patch.

    Args:
        src_points: 4 (x, y) points on the undistorted camera frame (the
            lane trapezoid, bottom-left/top-left/top-right/bottom-right).
        dst_points: the corresponding rectangle in the warped frame.
        image_size / warped_size: (W, H).
        patch_width_px/patch_height_px: pixel extent in the *warped* image
            of a patch whose real size is patch_width_m x patch_height_m
            (defaults: US lane width x dash spacing, notebook cell 11).
    """
    M = get_perspective_transform(src_points, dst_points)
    Minv = np.linalg.inv(M)
    # Normalize like getPerspectiveTransform(dst, src) would (H[2,2] = 1).
    Minv = Minv / Minv[2, 2]
    return WarpParams(
        M=M,
        Minv=Minv,
        image_width_height=tuple(int(v) for v in image_size),
        warped_width_height=tuple(int(v) for v in warped_size),
        mppv=float(patch_height_m) / float(patch_height_px),
        mpph=float(patch_width_m) / float(patch_width_px),
    )


def reference_warp_calibration() -> WarpParams:
    """The exact calibration the reference shipped (notebook cells 8-13):
    src trapezoid (242,695),(564,473),(721,473),(1064,695) -> dst rectangle
    x in {439, 643}, y in {380, 1100}; patch 196 x 146 px."""
    return calibrate_warp(
        src_points=[(242, 695), (564, 473), (721, 473), (1064, 695)],
        dst_points=[(439, 1100), (439, 380), (643, 380), (643, 1100)],
        image_size=(1280, 720),
        warped_size=(1080, 1100),
        patch_width_px=196,
        patch_height_px=146,
    )
