"""Offline camera calibration from chessboard images (numpy/scipy host code).

Copied from lane_tracker_tpu/calib/camera.py; tests/test_torch_host.py
pins ``calibrate_camera`` equal to the original on chessboard points
projected from a known camera.  The reference's calibration tool
(camera_calibration.py:14-95): assemble object/image point
correspondences from chessboard photos and estimate the pinhole
intrinsics + Brown-Conrady distortion, by Zhang's closed-form
initialization from per-image homographies followed by joint
Levenberg-Marquardt refinement (``scipy.optimize.least_squares``) rather
than ``cv2.calibrateCamera``.  Corner *detection* is perceptual, not
numeric, and is delegated to cv2 when present; reading the photos takes
PIL.  Both are imported only where photos are read (offline tooling; the
runtime never needs them), so without them the ``camera`` command raises
a clear error and ``calibrate_camera`` runs everywhere.

Also fixes the reference bug where ``calibrate_camera`` ignores its
``filepaths`` parameter and reads a global (camera_calibration.py:72-76).
"""

from __future__ import annotations

import glob as _glob
import importlib

import numpy as np

from lane_tracker_tpu_torch.calib.io import CameraParams


def chessboard_object_points(nx: int, ny: int) -> np.ndarray:
    """Planar (nx*ny, 3) grid of inner-corner coordinates (z = 0)."""
    obj = np.zeros((nx * ny, 3), np.float64)
    obj[:, :2] = np.mgrid[0:nx, 0:ny].T.reshape(-1, 2)
    return obj


def _cv2():
    """cv2, imported only where corners are detected."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "chessboard detection requires cv2 (offline tooling only)"
        ) from e
    return cv2


def find_chessboard_corners(image_rgb: np.ndarray, nx: int, ny: int):
    """Detect inner chessboard corners; returns (nx*ny, 2) or None.

    Delegates detection to cv2 (gated). Detection is an offline, perceptual
    task outside this framework's compute scope (SURVEY §2b N7).
    """
    cv2 = _cv2()
    gray = cv2.cvtColor(image_rgb, cv2.COLOR_RGB2GRAY)
    ok, corners = cv2.findChessboardCorners(gray, (nx, ny), None)
    if not ok:
        return None
    return corners.reshape(-1, 2).astype(np.float64)


def get_calibration_points(image_paths, nx: int, ny: int):
    """Correspondences from a list of image files.

    Mirrors the reference contract (camera_calibration.py:14-70) including
    the identical-size consistency check.

    Returns:
        (object_points, image_points, image_size): lists of (N,3)/(N,2)
        float64 arrays and the (W, H) image size.
    """
    _cv2()  # detection needs cv2: fail before reading any photo
    try:
        Image = importlib.import_module("PIL.Image")
    except ImportError as e:
        raise RuntimeError(
            "reading chessboard photos requires Pillow (PIL) (offline "
            "tooling only)") from e
    objp = chessboard_object_points(nx, ny)
    object_points, image_points = [], []
    image_size = None
    for path in image_paths:
        img = np.asarray(Image.open(path).convert("RGB"))
        size = (img.shape[1], img.shape[0])
        if image_size is None:
            image_size = size
        elif size != image_size:
            raise ValueError(
                "Expected all images to have identical size, "
                f"but found {size} vs {image_size}"
            )
        corners = find_chessboard_corners(img, nx, ny)
        if corners is not None:
            object_points.append(objp)
            image_points.append(corners)
    return object_points, image_points, image_size


# ---------------------------------------------------------------------------
# Zhang closed-form initialization


def _normalized_homography(obj_xy, img_xy):
    """DLT homography with Hartley normalization (full least squares over
    all points, unlike the 4-point exact solve)."""

    def normalize(pts):
        mean = pts.mean(axis=0)
        scale = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - mean, axis=1)), 1e-12)
        T = np.array(
            [[scale, 0, -scale * mean[0]], [0, scale, -scale * mean[1]], [0, 0, 1]]
        )
        homog = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        return (homog @ T.T)[:, :2], T

    src, Ts = normalize(obj_xy)
    dst, Td = normalize(img_xy)
    n = len(src)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, Vt = np.linalg.svd(A)
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def _intrinsics_from_homographies(Hs, image_size):
    """Zhang's B-matrix estimation of K from >= 3 homographies."""

    def v(H, i, j):
        return np.array(
            [
                H[0, i] * H[0, j],
                H[0, i] * H[1, j] + H[1, i] * H[0, j],
                H[1, i] * H[1, j],
                H[2, i] * H[0, j] + H[0, i] * H[2, j],
                H[2, i] * H[1, j] + H[1, i] * H[2, j],
                H[2, i] * H[2, j],
            ]
        )

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.stack(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    try:
        cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
        lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
        fx = np.sqrt(lam / b11)
        fy = np.sqrt(lam * b11 / (b11 * b22 - b12 * b12))
        cx = -b13 * fx * fx / lam
        if not (np.isfinite([fx, fy, cx, cy]).all() and fx > 0 and fy > 0):
            raise FloatingPointError
    except (FloatingPointError, ZeroDivisionError):
        # Degenerate configuration: fall back to a center guess.
        W, H = image_size
        fx = fy = 1.2 * W
        cx, cy = W / 2.0, H / 2.0
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _extrinsics_from_homography(K, H):
    """[R|t] from a plane homography given intrinsics."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / max(np.linalg.norm(Kinv @ h1), 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = np.cross(r1, r2)
    t = lam * (Kinv @ h3)
    R = np.stack([r1, r2, r3], axis=1)
    # Project onto SO(3).
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    return _rodrigues_from_matrix(R), t


def _rodrigues_from_matrix(R):
    cos = max(min((np.trace(R) - 1.0) / 2.0, 1.0), -1.0)
    theta = np.arccos(cos)
    if theta < 1e-12:
        return np.zeros(3)
    axis = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(theta))
    )
    return axis * theta


def _rodrigues_to_matrix(rvec):
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _project(params, obj_pts_list):
    """Project all boards' object points under packed parameters."""
    fx, fy, cx, cy = params[0:4]
    k1, k2, p1, p2, k3 = params[4:9]
    outs = []
    for i, obj in enumerate(obj_pts_list):
        rvec = params[9 + 6 * i : 12 + 6 * i]
        tvec = params[12 + 6 * i : 15 + 6 * i]
        R = _rodrigues_to_matrix(rvec)
        cam = obj @ R.T + tvec
        x = cam[:, 0] / cam[:, 2]
        y = cam[:, 1] / cam[:, 2]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        outs.append(np.stack([fx * xd + cx, fy * yd + cy], axis=1))
    return outs


def calibrate_camera(object_points, image_points, image_size, max_iters=60):
    """Estimate (CameraParams, rms_reprojection_error, extrinsics).

    Zhang initialization + joint Levenberg-Marquardt over intrinsics,
    distortion (k1 k2 p1 p2 k3), and per-view extrinsics — the same model
    ``cv2.calibrateCamera`` fits for the reference
    (camera_calibration.py:79).
    """
    n_views = len(object_points)
    if n_views < 3:
        raise ValueError("need at least 3 views for calibration")
    obj_xy = [np.asarray(o, np.float64)[:, :2] for o in object_points]
    img_xy = [np.asarray(p, np.float64) for p in image_points]

    Hs = [_normalized_homography(o, i) for o, i in zip(obj_xy, img_xy)]
    K = _intrinsics_from_homographies(Hs, image_size)

    params = np.zeros(9 + 6 * n_views)
    params[0:4] = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
    obj3 = [np.asarray(o, np.float64) for o in object_points]
    for i, H in enumerate(Hs):
        rvec, tvec = _extrinsics_from_homography(K, H)
        params[9 + 6 * i : 12 + 6 * i] = rvec
        params[12 + 6 * i : 15 + 6 * i] = tvec

    target = np.concatenate([p.reshape(-1) for p in img_xy])

    def residuals(p):
        proj = _project(p, obj3)
        return np.concatenate([q.reshape(-1) for q in proj]) - target

    from scipy.optimize import least_squares

    sol = least_squares(residuals, params, method="lm", max_nfev=max_iters * len(params))
    p = sol.x
    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
    dist = p[4:9].copy()
    rms = float(np.sqrt(np.mean(sol.fun**2) * 2.0))
    extrinsics = [
        (p[9 + 6 * i : 12 + 6 * i].copy(), p[12 + 6 * i : 15 + 6 * i].copy())
        for i in range(n_views)
    ]
    return CameraParams(K, dist), rms, extrinsics


def calibrate_from_images(pattern_or_paths, nx: int = 9, ny: int = 6):
    """One-call tool: glob/list of chessboard photos -> CameraParams.

    The reference's entry point (camera_calibration.py:89-95) with the
    filepaths-ignored bug fixed.
    """
    if isinstance(pattern_or_paths, str):
        paths = sorted(_glob.glob(pattern_or_paths))
    else:
        paths = list(pattern_or_paths)
    obj, img, size = get_calibration_points(paths, nx, ny)
    cam, rms, _ = calibrate_camera(obj, img, size)
    return cam, rms, size
