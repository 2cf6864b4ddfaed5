# Frozen copy of lane_tracker_tpu_torch/ops/morphology.py:1-102 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
"""Grayscale morphology with OpenCV's elliptical structuring elements.

Port of lane_tracker_tpu/ops/morphology.py.  ``ellipse_runs`` is copied
from there (lines 25-51).  The plain torch versions below serve as the
reference twins of the hand-written CUDA kernels
(kernels/filter_stage.py) and as the CPU path: the SE is one horizontal
run per SE row; each distinct run is a window min/max read off a shared
pow2 pyramid (two reads per run), then the SE rows combine vertically.

Border semantics match OpenCV's morphologyEx default: out-of-image pixels
never win, i.e. erode pads with 255 and dilate with 0.  All functions take
(..., H, W) uint8 tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def ellipse_runs(ksize: int):
    """Per-row horizontal runs of OpenCV's MORPH_ELLIPSE structuring element.

    Replicates cv2.getStructuringElement's ellipse rasterization (including
    its round-half-even saturate_cast) so the SE footprint is identical.

    Returns:
        Tuple of (dy, (lo, hi)) pairs: the SE row at vertical offset ``dy``
        from the anchor spans horizontal offsets [lo, hi].
    """
    if ksize < 1:
        raise ValueError("ksize must be >= 1")
    r = ksize // 2
    c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    runs = []
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r and r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, ksize)
            runs.append((dy, (j1 - c, j2 - 1 - c)))
        elif r == 0:
            runs.append((0, (0, 0)))
    return tuple(runs)


def _morph(img: torch.Tensor, ksize: int, op, fill: int) -> torch.Tensor:
    runs = ellipse_runs(ksize)
    r = ksize // 2
    H, W = img.shape[-2:]
    padded = img.new_full(img.shape[:-2] + (H + 2 * r, W + 2 * r), fill)
    padded[..., r:r + H, r:r + W] = img
    # levels[j][..., c] = op over padded columns [c, c + 2^j).
    max_run = max(hi - lo + 1 for _, (lo, hi) in runs)
    levels = [padded]
    length = 1
    while length * 2 <= max_run:
        g = levels[-1]
        levels.append(op(g[..., :-length], g[..., length:]))
        length *= 2

    by_extent = {}
    for dy, ext in runs:
        by_extent.setdefault(ext, []).append(dy)
    out = None
    for (lo, hi), dys in by_extent.items():
        n = hi - lo + 1
        p = 1 << (n.bit_length() - 1)
        g = levels[p.bit_length() - 1]
        h = g[..., r + lo:r + lo + W]
        if p != n:
            h = op(h, g[..., r + hi - p + 1:r + hi - p + 1 + W])
        for dy in dys:
            seg = h[..., r + dy:r + dy + H, :]
            out = seg if out is None else op(out, seg)
    return out.contiguous()


def erode_ellipse(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Grayscale erosion with a ksize x ksize elliptical SE (uint8)."""
    return _morph(img, ksize, torch.minimum, 255)


def dilate_ellipse(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Grayscale dilation with a ksize x ksize elliptical SE (uint8)."""
    return _morph(img, ksize, torch.maximum, 0)


def open_ellipse(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Morphological opening (erode then dilate)."""
    return dilate_ellipse(erode_ellipse(img, ksize), ksize)


def tophat_ellipse(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """White tophat: img - open(img).  Opening is anti-extensive, so the
    uint8 difference never wraps."""
    return img - open_ellipse(img, ksize)
