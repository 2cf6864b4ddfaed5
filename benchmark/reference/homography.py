# Frozen copy of lane_tracker_tpu_torch/calib/homography.py:1-150 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
"""Homography estimation and perspective sampling grids (numpy only).

Copied from lane_tracker_tpu/calib/homography.py (the 4-point solve
``get_perspective_transform`` and ``project_points``, :26 and :47, and the
grids); tests/test_torch_host.py pins each equal to the original's.  The
grids mirror OpenCV's resampling: 'fixed' rounds source coordinates to
1/32 px with 2^15 weights (classic warpPerspective / cv2.undistort maps),
'float' is OpenCV >= 5's single-precision bilinear path.
"""

from __future__ import annotations

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS  # 32 subpixel bins
COEF_BITS = 15
COEF_SCALE = 1 << COEF_BITS  # 2^15 weight scale


def get_perspective_transform(src_points, dst_points):
    """Solve the 3x3 homography mapping 4 src points to 4 dst points.

    Equivalent to ``cv2.getPerspectiveTransform``: sets up the standard 8x8
    DLT system and solves it, with H[2,2] fixed to 1.
    """
    src = np.asarray(src_points, dtype=np.float64).reshape(4, 2)
    dst = np.asarray(dst_points, dtype=np.float64).reshape(4, 2)
    A = np.zeros((8, 8), dtype=np.float64)
    b = np.zeros(8, dtype=np.float64)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def project_points(H, points):
    """Apply homography H to an (N, 2) array of points (float64)."""
    pts = np.asarray(points, dtype=np.float64)
    ones = np.ones((*pts.shape[:-1], 1), dtype=np.float64)
    homog = np.concatenate([pts, ones], axis=-1) @ H.T
    return homog[..., :2] / homog[..., 2:3]


def _round_half_even(x):
    # cvRound / saturate_cast<int>(double) semantics: round half to even.
    return np.rint(x).astype(np.int64)


def quantize_grid(sx, sy, src_size):
    """Quantize float source coordinates into the fixed-point gather grid.

    Coordinates are rounded to 1/32 px; the four bilinear weights
    (32-fx)(32-fy)*32 etc. are exact multiples summing to 2^15.  Returns a
    dict of (H, W) arrays: ix, iy (int32 top-left taps, possibly out of
    range) and w00..w11 (int32), plus ``src_size``.
    """
    src_w, src_h = int(src_size[0]), int(src_size[1])
    fx_full = _round_half_even(np.asarray(sx, dtype=np.float64) * INTER_TAB_SIZE)
    fy_full = _round_half_even(np.asarray(sy, dtype=np.float64) * INTER_TAB_SIZE)
    # Clamp to a safe integer range to avoid overflow in downstream int32 math.
    lim = 1 << 24
    fx_full = np.clip(fx_full, -lim, lim)
    fy_full = np.clip(fy_full, -lim, lim)
    ix = (fx_full >> INTER_BITS).astype(np.int32)
    iy = (fy_full >> INTER_BITS).astype(np.int32)
    ax = (fx_full & (INTER_TAB_SIZE - 1)).astype(np.int32)
    ay = (fy_full & (INTER_TAB_SIZE - 1)).astype(np.int32)
    w00 = (INTER_TAB_SIZE - ax) * (INTER_TAB_SIZE - ay) * INTER_TAB_SIZE
    w01 = ax * (INTER_TAB_SIZE - ay) * INTER_TAB_SIZE
    w10 = (INTER_TAB_SIZE - ax) * ay * INTER_TAB_SIZE
    w11 = ax * ay * INTER_TAB_SIZE
    return {
        "ix": ix,
        "iy": iy,
        "w00": w00.astype(np.int32),
        "w01": w01.astype(np.int32),
        "w10": w10.astype(np.int32),
        "w11": w11.astype(np.int32),
        "src_size": (src_w, src_h),
    }


def perspective_source_coords(M, dst_size):
    """Float64 source coordinates ``M^-1 @ (x, y, 1)`` of every destination
    pixel of ``cv2.warpPerspective(src, M, dst_size)``, shape (H, W)."""
    W, H = int(dst_size[0]), int(dst_size[1])
    Minv = np.linalg.inv(np.asarray(M, dtype=np.float64))
    xs = np.arange(W, dtype=np.float64)
    ys = np.arange(H, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)
    w = Minv[2, 0] * X + Minv[2, 1] * Y + Minv[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_w = np.where(w != 0, 1.0 / w, 0.0)
    sx = (Minv[0, 0] * X + Minv[0, 1] * Y + Minv[0, 2]) * inv_w
    sy = (Minv[1, 0] * X + Minv[1, 1] * Y + Minv[1, 2]) * inv_w
    return sx, sy


def perspective_source_coords_f32(M, dst_size):
    """Float32 source coordinates of a perspective warp, as OpenCV >= 5
    computes them: f32 inverse matrix, f32 per-pixel projective divide."""
    W, H = int(dst_size[0]), int(dst_size[1])
    Minv = np.linalg.inv(np.asarray(M, dtype=np.float64)).astype(np.float32)
    xs = np.arange(W, dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys)
    w = Minv[2, 0] * X + Minv[2, 1] * Y + Minv[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_w = np.where(w != 0, np.float32(1.0) / w, np.float32(0.0))
    sx = ((Minv[0, 0] * X + Minv[0, 1] * Y + Minv[0, 2]) * inv_w).astype(np.float32)
    sy = ((Minv[1, 0] * X + Minv[1, 1] * Y + Minv[1, 2]) * inv_w).astype(np.float32)
    return sx, sy


def float_grid(sx, sy, src_size):
    """Float-weight gather grid: integer taps from floor(), float32
    bilinear weights (the float-path counterpart of quantize_grid)."""
    src_w, src_h = int(src_size[0]), int(src_size[1])
    sx = np.asarray(sx, dtype=np.float32)
    sy = np.asarray(sy, dtype=np.float32)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    lim = 1 << 24
    x0 = np.clip(x0, -lim, lim)
    y0 = np.clip(y0, -lim, lim)
    ax = (sx - x0).astype(np.float32)
    ay = (sy - y0).astype(np.float32)
    one = np.float32(1.0)
    return {
        "ix": x0.astype(np.int32),
        "iy": y0.astype(np.int32),
        "w00": ((one - ax) * (one - ay)).astype(np.float32),
        "w01": (ax * (one - ay)).astype(np.float32),
        "w10": ((one - ax) * ay).astype(np.float32),
        "w11": (ax * ay).astype(np.float32),
        "src_size": (src_w, src_h),
    }


def perspective_grid(M, src_size, dst_size):
    """Float-path gather grid of ``cv2.warpPerspective(src, M, dst_size)``
    (the only mode the port's pipelines use)."""
    sx, sy = perspective_source_coords_f32(M, dst_size)
    return float_grid(sx, sy, src_size)
