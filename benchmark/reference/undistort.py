# Frozen copy of lane_tracker_tpu_torch/calib/undistort.py:1-87 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
"""Camera undistortion sampling grids, Brown-Conrady model (numpy only).

Copied from lane_tracker_tpu/calib/undistort.py (distort_points,
undistort_source_coords, undistort_grid, fused_undistort_warp_coords,
fused_undistort_warp_grid);
tests/test_torch_host.py pins the grid and the fused coordinates equal to
the original's.  The remap is built once on the host in
float64 and quantized with OpenCV's 1/32-px fixed-point scheme, so the
device-side gather reproduces ``cv2.undistort`` exactly.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.homography import (
    float_grid,
    perspective_source_coords,
    quantize_grid,
)


def distort_points(cam_matrix, dist_coeffs, x, y):
    """Map ideal (undistorted) pixel coordinates to distorted pixel coords
    (``cv2.initUndistortRectifyMap`` with R = I and newCameraMatrix =
    cam_matrix).  Supports 4, 5, 8, 12 or 14 coefficient layouts."""
    K = np.asarray(cam_matrix, dtype=np.float64)
    d = np.zeros(14, dtype=np.float64)
    dc = np.asarray(dist_coeffs, dtype=np.float64).reshape(-1)
    d[: dc.size] = dc
    k1, k2, p1, p2, k3, k4, k5, k6 = d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7]
    s1, s2, s3, s4 = d[8], d[9], d[10], d[11]

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    xn = (np.asarray(x, dtype=np.float64) - cx) / fx
    yn = (np.asarray(y, dtype=np.float64) - cy) / fy

    r2 = xn * xn + yn * yn
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xy2 = 2.0 * xn * yn
    xd = xn * radial + p1 * xy2 + p2 * (r2 + 2.0 * xn * xn) + s1 * r2 + s2 * r4
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + p2 * xy2 + s3 * r2 + s4 * r4

    u = fx * xd + cx
    v = fy * yd + cy
    return u, v


def undistort_source_coords(cam_matrix, dist_coeffs, size):
    """Float64 (sx, sy) of shape (H, W): for every undistorted output
    pixel, the location in the distorted source image to sample."""
    W, H = int(size[0]), int(size[1])
    xs = np.arange(W, dtype=np.float64)
    ys = np.arange(H, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)
    return distort_points(cam_matrix, dist_coeffs, X, Y)


def undistort_grid(cam_matrix, dist_coeffs, size):
    """Fixed-point gather grid reproducing ``cv2.undistort`` exactly."""
    sx, sy = undistort_source_coords(cam_matrix, dist_coeffs, size)
    return quantize_grid(sx, sy, size)


def fused_undistort_warp_coords(cam_matrix, dist_coeffs, M, src_size, dst_size):
    """Float64 (sx, sy) into the RAW frame, shape (H, W) of the bird's-eye
    view: each output pixel inverse-mapped through the homography, then
    forward-distorted (undistort and warp composed into one grid, the
    banded warp's pass-2 taps)."""
    ux, uy = perspective_source_coords(M, dst_size)
    return distort_points(cam_matrix, dist_coeffs, ux, uy)


def fused_undistort_warp_grid(cam_matrix, dist_coeffs, M, src_size, dst_size,
                              mode="float"):
    """Gather grid of the fused undistort + warp (copied from
    lane_tracker_tpu/calib/undistort.py:103-114): mode 'float' (full float
    bilinear) or 'fixed' (1/32-px quantized, classic OpenCV)."""
    sx, sy = fused_undistort_warp_coords(cam_matrix, dist_coeffs, M, src_size,
                                         dst_size)
    if mode == "float":
        return float_grid(sx, sy, src_size)
    return quantize_grid(sx, sy, src_size)
