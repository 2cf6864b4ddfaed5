"""The benchmark's one traffic generator: dashcam motion frames.

Frozen copy of the arithmetic of lane_tracker_tpu_torch/io/motion.py:41-179
(commit 6cc3612; itself OpenCV 5's float32 ``warpAffine`` path, value for
value): segments of ``segment`` frames rotate through the corpus stills
(assets/stills_720p.npz), each frame its scene under a slowly varying
affine jitter (a shift, a rotation and a zoom, each a sine of the frame
index) with reflected borders.  Two changes, both parameters of a mix:

* ``--seed`` shifts the four sines' phases, drawn per stream from the
  seed; at phase 0 a frame equals io/motion.py's.  Which scene a frame
  shows and which frames are black do not depend on the seed, so the work
  a chunk makes does not either.
* A mix file (traffic/<mix>.json) says which frames each stream cycles
  through: ``scene_order`` (indices into the stills), ``segment``,
  ``pool_frames`` consecutive frames a stream, stream s starting at
  frame ``(s % len(scene_order)) * segment``, and ``dropouts``, runs of
  black frames ``[first, length]`` counted from a pool's start.

Frames are made on the device in batches of ``batch`` frames.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

from benchmark.reference.resample import fma_f32

STILLS = pathlib.Path("assets") / "stills_720p.npz"
# Periods (frames) and amplitudes of the jitter's sines: dx, dy (px), the
# angle (degrees) and the zoom (io/motion.py:56-60).
PERIODS = (173.0, 97.0, 211.0, 131.0)
AMPLITUDES = (6.0, 2.5, 0.3, 0.005)


def phases(seed: int, n_streams: int) -> np.ndarray:
    """(n_streams, 4) phases in [0, 2 pi) drawn from ``seed``, any whole
    number."""
    rng = np.random.default_rng(int(seed) % 2**64)
    return rng.uniform(0.0, 2 * np.pi, size=(n_streams, 4))


def jitter(t: int, phase=(0.0, 0.0, 0.0, 0.0)) -> tuple:
    """(dx, dy, ang, zoom) of frame t, as io/motion.py computes them, each
    sine shifted by its phase."""
    dx, dy, ang, dz = (
        float(a * np.sin(2 * np.pi * t / p + f))
        for a, p, f in zip(AMPLITUDES, PERIODS, phase))
    return dx, dy, ang, 1.0 + dz


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` in OpenCV's order (io/motion.py:63-77)."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
    ], dtype=np.float64)


def invert_affine(M) -> np.ndarray:
    """``cv2.invertAffineTransform`` in OpenCV's order (io/motion.py:80-89)."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(-1)]
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22, a12, a21 = m[4] * D, m[0] * D, -m[1] * D, -m[3] * D
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]], dtype=np.float64)


def frame_matrix(t: int, width: int, height: int, phase) -> np.ndarray:
    """Frame t's forward affine (io/motion.py:92-98)."""
    dx, dy, ang, zoom = jitter(t, phase)
    M = rotation_matrix((width / 2, height / 2), ang, zoom)
    M[:, 2] += (dx, dy)
    return M


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV's BORDER_REFLECT_101 index (io/motion.py:101-107)."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    p = i.abs() % period
    return torch.where(p >= n, period - p, p)


def warp_affine(imgs: torch.Tensor, inverses: np.ndarray) -> torch.Tensor:
    """A batch of ``warpAffine(INTER_LINEAR, BORDER_REFLECT_101)``: (B, H,
    W, C) uint8 images, each by its (2, 3) float64 inverse matrix, by
    io/motion.py:110-143's float32 arithmetic, element for element."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    mi = torch.tensor(np.float32(inverses), device=dev)[:, :, :, None, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]

    def source(row):
        rx = ys * mi[:, row, 1] + mi[:, row, 2]  # two f32 roundings
        return fma_f32(mi[:, row, 0], xs, rx)  # (B, H, W)

    sx, sy = source(0), source(1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    xi, yi = x0.long(), y0.long()
    cols = [_reflect101(xi + d, W) for d in (0, 1)]
    rows = [_reflect101(yi + d, H) for d in (0, 1)]
    flat = imgs.reshape(B * H * W, C)
    first = (torch.arange(B, device=dev) * (H * W))[:, None, None]

    def tap(r, c):
        return flat[(first + rows[r] * W + cols[c]).reshape(-1)].reshape(
            B, H, W, C).float()

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    t0 = fma_f32(ax, p01 - p00, p00)
    t1 = fma_f32(ax, p11 - p10, p10)
    v = fma_f32(ay, t1 - t0, t0)
    return torch.round(v).clamp_(0, 255).to(torch.uint8)


def pool_plan(mix: dict, n_streams: int) -> list[list[tuple[int, int]]]:
    """Per stream, per pool frame, (frame index t, scene) with scene -1
    for a black frame: the same for every seed."""
    seg = int(mix["segment"])
    order = [int(s) for s in mix["scene_order"]]
    black = {first + k for first, n in mix["dropouts"] for k in range(n)}
    plan = []
    for s in range(n_streams):
        start = (s % len(order)) * seg
        frames = []
        for i in range(int(mix["pool_frames"])):
            t = start + i
            scene = -1 if i in black else order[(t // seg) % len(order)]
            frames.append((t, scene))
        plan.append(frames)
    return plan


def load_scenes(root: pathlib.Path, device) -> torch.Tensor:
    with np.load(root / STILLS) as z:
        return torch.from_numpy(z["frames"]).to(device)


def make_pools(mix: dict, seed: int, n_streams: int, device,
               root: pathlib.Path) -> torch.Tensor:
    """(n_streams, pool_frames, 720, 1280, 3) uint8 frames on ``device``."""
    plan = pool_plan(mix, n_streams)
    ph = phases(seed, n_streams)
    scenes = load_scenes(root, device)
    H, W = scenes.shape[1:3]
    out = torch.zeros((n_streams, len(plan[0])) + tuple(scenes.shape[1:]),
                      dtype=torch.uint8, device=device)
    jobs = [(s, i, t, scene) for s, frames in enumerate(plan)
            for i, (t, scene) in enumerate(frames) if scene >= 0]
    batch = int(mix.get("batch", 16))
    for k in range(0, len(jobs), batch):
        part = jobs[k:k + batch]
        inv = np.stack([invert_affine(frame_matrix(t, W, H, ph[s]))
                        for s, _, t, _ in part])
        src = scenes[torch.tensor([scene for *_, scene in part],
                                  device=device)]
        warped = warp_affine(src, inv)
        for j, (s, i, _, _) in enumerate(part):
            out[s, i] = warped[j]
    return out
