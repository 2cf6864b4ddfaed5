"""Motion frames: the corpus stills under a slowly varying affine jitter.

Port of ``motion_sequence`` (scripts/motion_longrun.py:30-63), the frames
of bench.py's BENCH_MOTION=1 chunk, without OpenCV or PIL.  Segments of
150 frames rotate through three scenes (frames 0-2 of
assets/stills_720p.npz, the decodes of frame911.jpg, frame971.jpg and
test4.jpg); within a segment each frame is its scene under the affine
``getRotationMatrix2D((W/2, H/2), ang, zoom)`` shifted by (dx, dy), with
dx, dy, ang and zoom slow sines of t, and reflected borders.  Frames
3*150 + 0..5 and 6*150 + 0..2 are black (dropouts).  Every other frame is
unique, so band search follows moving content.

The script warps with ``cv2.warpAffine(INTER_LINEAR, BORDER_REFLECT_101)``
on uint8, which OpenCV 5 takes through a float32 path.  This module
computes that path's arithmetic on tensors, value for value:

* the matrix and its inverse on the host in float64, in OpenCV's order of
  operations (``rotation_matrix``, ``invert_affine``), with ``math.cos`` /
  ``math.sin`` as OpenCV calls the C library; the inverse rounded to f32;
* per row ``rx = f32(f32(m01 * y) + m02)``, per pixel ``sx = fma(m00, x,
  rx)`` (and ``sy`` from row 1); ``x0 = floor(sx)``, ``ax = sx - x0``;
* taps reflected (reflect-101), ``t0 = fma(ax, p01 - p00, p00)``, ``t1 =
  fma(ax, p11 - p10, p10)``, ``v = fma(ay, t1 - t0, t0)``, all f32;
* round half to even, clip to [0, 255].

Each fma is ``kernels.resample.fma_f32``, correctly rounded.
tests/test_torch_motion.py holds the frames to the script's (cv2) with 0
values differing.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

from lane_tracker_tpu_torch.device import DEFAULT_DEVICE, entry_device
from lane_tracker_tpu_torch.kernels.resample import fma_f32

SEGMENT = 150
N_SCENES = 3
DROPOUTS = frozenset({(3, k) for k in range(6)} | {(6, k) for k in range(3)})
STILLS = (pathlib.Path(__file__).resolve().parents[2] / "assets"
          / "stills_720p.npz")


def is_dropout(t: int) -> bool:
    """Frame t is one of the sequence's black frames."""
    return divmod(int(t), SEGMENT) in DROPOUTS


def jitter(t: int) -> tuple[float, float, float, float]:
    """(dx, dy, ang, zoom) of frame t, computed as the script computes
    them (numpy scalars, float64)."""
    dx = 6.0 * np.sin(2 * np.pi * t / 173.0)
    dy = 2.5 * np.sin(2 * np.pi * t / 97.0)
    ang = 0.3 * np.sin(2 * np.pi * t / 211.0)
    zoom = 1.0 + 0.005 * np.sin(2 * np.pi * t / 131.0)
    return float(dx), float(dy), float(ang), float(zoom)


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)`` (2, 3) float64,
    in OpenCV's order: the angle in radians by ``CV_PI/180``, then
    ``alpha = cos * scale``, ``beta = sin * scale``.  ``center`` is a
    float32 point in OpenCV, so it is rounded to f32 first."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ], dtype=np.float64)


def invert_affine(M) -> np.ndarray:
    """``cv2.invertAffineTransform(M)`` of a (2, 3) float64 matrix, in
    OpenCV's order of operations."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(-1)]
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22, a12, a21 = m[4] * D, m[0] * D, -m[1] * D, -m[3] * D
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]], dtype=np.float64)


def frame_matrix(t: int, width: int, height: int) -> np.ndarray:
    """The script's forward affine of frame t: the rotation and zoom about
    the frame's centre, then the shift (dx, dy)."""
    dx, dy, ang, zoom = jitter(t)
    M = rotation_matrix((width / 2, height / 2), ang, zoom)
    M[:, 2] += (dx, dy)
    return M


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV's BORDER_REFLECT_101 index: ... 2 1 | 0 1 2 ... n-1 | n-2 ..."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    p = i.abs() % period
    return torch.where(p >= n, period - p, p)


def warp_affine(img: torch.Tensor, M) -> torch.Tensor:
    """``cv2.warpAffine(img, M, (W, H), INTER_LINEAR, BORDER_REFLECT_101)``
    of an (H, W, C) uint8 tensor, by OpenCV 5's float32 path (module
    docstring), on ``img.device``."""
    H, W, C = img.shape
    dev = img.device
    mi = torch.tensor(np.float32(invert_affine(M)), device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]

    def source(row):
        rx = ys * mi[row, 1] + mi[row, 2]  # two f32 roundings
        return fma_f32(mi[row, 0], xs, rx)  # (H, W)

    sx, sy = source(0), source(1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    xi, yi = x0.long(), y0.long()
    cols = [_reflect101(xi + d, W) for d in (0, 1)]
    rows = [_reflect101(yi + d, H) for d in (0, 1)]
    flat = img.reshape(H * W, C)

    def tap(r, c):
        return flat[(rows[r] * W + cols[c]).reshape(-1)].reshape(
            H, W, C).float()

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    t0 = fma_f32(ax, p01 - p00, p00)
    t1 = fma_f32(ax, p11 - p10, p10)
    v = fma_f32(ay, t1 - t0, t0)
    return torch.round(v).clamp_(0, 255).to(torch.uint8)


def load_scenes(device=DEFAULT_DEVICE) -> torch.Tensor:
    """The three scenes, (3, 720, 1280, 3) uint8 on ``device``."""
    with np.load(STILLS) as z:
        frames = z["frames"][:N_SCENES]
    return torch.from_numpy(frames).to(entry_device(device))


def motion_frame(t: int, scenes: torch.Tensor) -> torch.Tensor:
    """Frame t, (H, W, 3) uint8 on ``scenes.device``."""
    if is_dropout(t):
        return torch.zeros_like(scenes[0])
    scene = scenes[(int(t) // SEGMENT) % N_SCENES]
    H, W = scene.shape[:2]
    return warp_affine(scene, frame_matrix(t, W, H))


def motion_sequence(n_frames: int, seed: int = 7, device=DEFAULT_DEVICE):
    """Yield (t, frame) for t < n_frames, each frame (720, 1280, 3) uint8
    on ``device`` (the card unless the caller passes ``device="cpu"``).
    ``seed`` is the script's, which the sequence does not use: it is
    deterministic."""
    del seed
    scenes = load_scenes(device)
    for t in range(n_frames):
        yield t, motion_frame(t, scenes)


def motion_chunk(n_frames: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Frames 0 .. n_frames - 1 as one (T, 720, 1280, 3) uint8 tensor on
    ``device`` (bench.py's motion chunk is ``motion_chunk(512)``).  Frames
    are made one at a time into the chunk, so the working set is one
    frame's."""
    scenes = load_scenes(device)
    out = torch.empty((n_frames,) + tuple(scenes.shape[1:]),
                      dtype=torch.uint8, device=scenes.device)
    for t in range(n_frames):
        out[t] = motion_frame(t, scenes)
    return out
