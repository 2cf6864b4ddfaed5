"""Bilinear gather resampling with precomputed grids.

Port of lane_tracker_tpu/kernels/resample.py.  The host-side slot remap
(``slot_remap``, copied from ``ResampleGrid.from_quantized``) clips each
destination pixel's 2x2 tap window inside the source image and moves every
in-bounds tap's weight onto its window slot, so four plain index gathers
plus ``combine_taps`` reproduce OpenCV's resampling with BORDER_CONSTANT(0).
The reference's u32 tap packing is a TPU gather-count device and is not
carried over: here the taps are four ``index_select``s.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

COEF_BITS = 15
_ROUND = 1 << (COEF_BITS - 1)


def slot_remap(grid: dict) -> dict:
    """Host-side window/slot remap of a quantized grid (numpy).

    Returns ``{"base", "w00", "w01", "w10", "w11", "src_size"}``: ``base``
    is the int32 flattened source index of the clipped window's top-left
    corner; weights keep the grid's dtype (int32 fixed, float32 float).
    """
    src_w, src_h = grid["src_size"]
    ix = grid["ix"].astype(np.int64)
    iy = grid["iy"].astype(np.int64)
    bx = np.clip(ix, 0, src_w - 2)
    by = np.clip(iy, 0, src_h - 2)
    wdtype = grid["w00"].dtype
    pw = {slot: np.zeros(ix.shape, wdtype)
          for slot in ((0, 0), (0, 1), (1, 0), (1, 1))}
    for (dy, dx), key in (((0, 0), "w00"), ((0, 1), "w01"),
                          ((1, 0), "w10"), ((1, 1), "w11")):
        ty = iy + dy
        tx = ix + dx
        inb = (tx >= 0) & (tx < src_w) & (ty >= 0) & (ty < src_h)
        sy = ty - by  # in-bounds taps land within the clipped window
        sx = tx - bx
        for slot in pw:
            hit = inb & (sy == slot[0]) & (sx == slot[1])
            pw[slot] = pw[slot] + np.where(hit, grid[key], 0).astype(wdtype)
    return {
        "base": (by * src_w + bx).astype(np.int32),
        "w00": pw[(0, 0)],
        "w01": pw[(0, 1)],
        "w10": pw[(1, 0)],
        "w11": pw[(1, 1)],
        "src_size": (int(src_w), int(src_h)),
    }


class ResampleGrid(nn.Module):
    """A slot-remapped sampling grid as buffers (``.to(device)`` moves it).

    ``base`` is stored flattened as int64 (the index type of
    ``index_select``); ``dst_shape`` keeps the destination (H, W).  Float
    weights are held as float64 copies of their float32 values, the dtype
    ``combine_taps`` computes its multiply-adds in, so no chunk converts
    them again.
    """

    def __init__(self, base, w00, w01, w10, w11, src_size):
        super().__init__()
        base = np.asarray(base)
        self.dst_shape = tuple(int(v) for v in base.shape)
        self.src_size = (int(src_size[0]), int(src_size[1]))
        self.register_buffer(
            "base", torch.from_numpy(base.reshape(-1).astype(np.int64)))
        for name, w in (("w00", w00), ("w01", w01), ("w10", w10),
                        ("w11", w11)):
            w = np.asarray(w).reshape(-1)
            if w.dtype == np.float32:
                w = w.astype(np.float64)
            self.register_buffer(name, torch.tensor(w))

    @classmethod
    def from_remapped(cls, g: dict) -> "ResampleGrid":
        return cls(g["base"], g["w00"], g["w01"], g["w10"], g["w11"],
                   g["src_size"])

    @property
    def is_float(self) -> bool:
        return self.w00.dtype == torch.float64


def _fma(p: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``p * w + c`` for uint8 taps ``p``, float64-held f32 weights ``w``
    and an f32 partial sum ``c``, computed in float64 and rounded to f32.

    The product (8 by 24 significant bits) is exact in float64.  The sum
    is exact, so the result is one f32 rounding as in a true fma, whenever
    the two addends' bits span at most 53 places; otherwise it rounds in
    float64 first, and that double rounding can differ from a true fma in
    the last f32 place.  Bit-exactness with the reference is checked on
    the four stills (tests/test_torch_color_warp.py), not proven for
    every grid."""
    return (p.double() * w + c.double()).float()


def combine_taps(p00, p01, p10, p11, grid: ResampleGrid):
    """Weighted combine of the four window-slot taps (the reference's one
    arithmetic definition, resample.py:103-130).  Taps are (..., N, C)
    uint8; weights broadcast over the trailing channel axis.

    Float grids: the f32 sum of the four tap products in the fused
    multiply-add chain XLA contracts the reference's sum into,
    ``fma(p11, w11, fma(p10, w10, fma(p00, w00, p01 * w01)))``, then
    round-half-even and clip; bit-exact with the reference on the CPU.
    Fixed grids: 2^15 int weights, ``(acc + 2^14) >> 15``, clip.
    """
    ws = [w[:, None] for w in (grid.w00, grid.w01, grid.w10, grid.w11)]
    if grid.is_float:
        # The f32 product p01 * w01: exact in float64, rounded once.
        acc = (p01.double() * ws[1]).float()
        for p, w in ((p00, ws[0]), (p10, ws[2]), (p11, ws[3])):
            acc = _fma(p, w, acc)
        return torch.round(acc).clamp_(0, 255).to(torch.uint8)
    acc = (p00.int() * ws[0] + p01.int() * ws[1]
           + p10.int() * ws[2] + p11.int() * ws[3])
    return ((acc + _ROUND) >> COEF_BITS).clamp_(0, 255).to(torch.uint8)


def bilinear_gather(img: torch.Tensor, grid: ResampleGrid) -> torch.Tensor:
    """Resample a (T, Hs, Ws, C) uint8 batch through ``grid``.

    Returns (T, H, W, C) uint8 with (H, W) = ``grid.dst_shape``.
    """
    T, Hs, Ws, C = img.shape
    if (Ws, Hs) != grid.src_size:
        raise ValueError(f"image {(Ws, Hs)} does not match grid source "
                         f"{grid.src_size}")
    flat = img.reshape(T, Hs * Ws, C)
    taps = [flat.index_select(1, grid.base + off)
            for off in (0, 1, Ws, Ws + 1)]
    out = combine_taps(*taps, grid)
    return out.reshape(T, *grid.dst_shape, C)
