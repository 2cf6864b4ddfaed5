"""Synthetic calibrations for tests, dry runs, and shape exploration.

Copied from lane_tracker_tpu/calib/synthetic.py (``make_synthetic_calibration``
:17, ``tiny_config`` :54), built on the port's own calibration containers
and config dataclasses; tests/test_torch_host.py pins both equal to the
originals, field by field.  A plausible (camera, warp) pair at any
geometry: mild Brown-Conrady distortion and a road-like trapezoid
homography scaled from the reference's real calibration proportions.  The
fleet's CPU tests run at its tiny geometry.
"""

from __future__ import annotations

import numpy as np

from lane_tracker_tpu_torch.calib.homography import get_perspective_transform
from lane_tracker_tpu_torch.calib.io import CameraParams, WarpParams
from lane_tracker_tpu_torch.tracker.config import (
    FilterConfig,
    SearchConfig,
    TrackerConfig,
    ValidityConfig,
)


def make_synthetic_calibration(img_size=(128, 96), warped_size=(96, 128)):
    """Return (CameraParams, WarpParams) for the given geometry."""
    W, H = int(img_size[0]), int(img_size[1])
    Ww, Hw = int(warped_size[0]), int(warped_size[1])
    f = 0.9 * W
    cam = CameraParams(
        cam_matrix=np.array([[f, 0.0, W / 2], [0.0, f, H / 2],
                             [0.0, 0.0, 1.0]]),
        dist_coeffs=np.array([-0.2, 0.05, 1e-3, -5e-4, -0.01]),
    )
    # Trapezoid proportions scaled from the reference warp calibration
    # (perspective_transformation.ipynb cell 8).
    src = [
        (0.19 * W, 0.965 * H),
        (0.44 * W, 0.657 * H),
        (0.56 * W, 0.657 * H),
        (0.83 * W, 0.965 * H),
    ]
    dst = [
        (0.41 * Ww, Hw),
        (0.41 * Ww, 0.345 * Hw),
        (0.60 * Ww, 0.345 * Hw),
        (0.60 * Ww, Hw),
    ]
    M = get_perspective_transform(src, dst)
    warp = WarpParams(
        M=M,
        Minv=np.linalg.inv(M),
        image_width_height=(W, H),
        warped_width_height=(Ww, Hw),
        mppv=3.05 / (0.13 * Hw),
        mpph=3.66 / (0.19 * Ww),
    )
    return cam, warp


def tiny_config() -> TrackerConfig:
    """A TrackerConfig scaled for ~100px synthetic geometries."""
    return TrackerConfig(
        filter=FilterConfig(ksize_r=5, C_r=4, ksize_b=7, C_b=3,
                            mask_noise=False),
        search=SearchConfig(
            window_width=8,
            window_height=8,
            search_range=6,
            no_success_limit=4,
            ignore_sides=8,
            ignore_bottom=4,
            bandwidth=6,
        ),
        validity=ValidityConfig(
            min_dist_y1=4,
            max_dist_y1=96,
            min_dist_y2=2,
            max_dist_y2=96,
            min_dist_y3=1,
            max_dist_y3=96,
            tangent_thresh=2.0,
        ),
        n_tries=2,
    )
