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
    them again.  ``rounded`` lists the flattened pixels whose multiply-adds
    take ``fma_f32``'s round-to-odd correction (``needs_fma``); it is empty
    for fixed grids.
    """

    def __init__(self, base, w00, w01, w10, w11, src_size):
        super().__init__()
        base = np.asarray(base)
        self.dst_shape = tuple(int(v) for v in base.shape)
        self.src_size = (int(src_size[0]), int(src_size[1]))
        self.register_buffer(
            "base", torch.from_numpy(base.reshape(-1).astype(np.int64)))
        ws = [np.asarray(w).reshape(-1) for w in (w00, w01, w10, w11)]
        for name, w in zip(("w00", "w01", "w10", "w11"), ws):
            if w.dtype == np.float32:
                w = w.astype(np.float64)
            self.register_buffer(name, torch.tensor(w))
        rounded = (np.flatnonzero(needs_fma(*ws)) if ws[0].dtype.kind == "f"
                   else np.zeros(0))
        self.register_buffer(
            "rounded", torch.from_numpy(rounded.astype(np.int64)))

    @classmethod
    def from_remapped(cls, g: dict) -> "ResampleGrid":
        return cls(g["base"], g["w00"], g["w01"], g["w10"], g["w11"],
                   g["src_size"])

    @property
    def is_float(self) -> bool:
        return self.w00.dtype == torch.float64

    def copy_to(self, device) -> "ResampleGrid":
        """A new grid with a copy of every buffer on ``device``."""
        return self._with(self.dst_shape, self.src_size, {
            name: buf.to(device, copy=True)
            for name, buf in self.named_buffers(recurse=False)})

    @classmethod
    def _with(cls, dst_shape, src_size, buffers: dict) -> "ResampleGrid":
        new = cls.__new__(cls)
        nn.Module.__init__(new)
        new.dst_shape, new.src_size = tuple(dst_shape), tuple(src_size)
        for name, buf in buffers.items():
            new.register_buffer(name, buf)
        return new


# Every nonzero weight at least 2^-20 (an f32, so its last bit at least
# 2^-43) and their sum at most 4: then each tap product, each f32 partial
# sum and their exact sum are multiples of 2^-43 below 255 * 4 < 2^10,
# which 53 bits hold.  The float64 sum is then exact and the one rounding
# to f32 is the fma's.
EXACT_MIN_WEIGHT = 2.0 ** -20
EXACT_MAX_WEIGHT_SUM = 4.0


def needs_fma(*ws: np.ndarray) -> np.ndarray:
    """Per pixel of float weights ``ws`` (one array per slot): True where
    the plain float64 multiply-add may round twice, so ``combine_taps``
    needs ``fma_f32`` there; False where it is exact (see EXACT_MIN_WEIGHT)."""
    ws = [np.asarray(w, np.float64) for w in ws]
    tiny = np.zeros(ws[0].shape, bool)
    for w in ws:
        tiny |= (w != 0) & ~(np.abs(w) >= EXACT_MIN_WEIGHT)
    return tiny | ~(sum(np.abs(w) for w in ws) <= EXACT_MAX_WEIGHT_SUM)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fma(a, b, c)``: the correctly rounded f32 of the exact ``a*b + c``
    for tensors holding f32 values (uint8, float32, or float64 holding
    f32 values), on any device; float32 out.

    The product of two f32 values (24 by 24 significant bits) is exact in
    float64.  The float64 sum ``s`` and its TwoSum residual ``e`` give the
    exact sum ``s + e``; rounding it to odd (step ``s`` one place toward
    zero where ``e`` has the opposite sign, then set its last bit where
    ``e != 0``) gives a float64 whose rounding to nearest f32 equals the
    rounding of the exact sum, because 53 >= 24 + 2 (round-to-odd at two
    or more extra bits never turns into a tie, nor moves off one).  So
    this is one f32 rounding, as a true fma, for every input."""
    p = a.double() * b.double()  # exact; c promotes inside the adds
    s = p + c
    bb = s - p
    e = (p - (s - bb)).add_(c - bb)
    # e and s of opposite signs: the exact sum lies below s in magnitude.
    bits = s.view(torch.int64).sub_((e * s < 0).long())
    return bits.bitwise_or_((e != 0).long()).view(torch.float64).float()


def _fma_chain(p00, p01, p10, p11, ws):
    """The f32 chain ``fma(p11, w11, fma(p10, w10, fma(p00, w00, p01 *
    w01)))`` with ``fma_f32``."""
    acc = (p01 * ws[1]).float()  # exact in float64, rounded once
    for p, w in ((p00, ws[0]), (p10, ws[2]), (p11, ws[3])):
        acc = fma_f32(p, w, acc)
    return acc


def combine_taps(p00, p01, p10, p11, grid: ResampleGrid, bias=None):
    """Weighted combine of the four window-slot taps (the reference's one
    arithmetic definition, resample.py:103-130).  Taps are (..., N, C)
    uint8 (or float32 holding 0..255); weights broadcast over the trailing
    channel axis.

    Float grids: the f32 sum of the four tap products in the fused
    multiply-add chain XLA contracts the reference's sum into,
    ``fma(p11, w11, fma(p10, w10, fma(p00, w00, p01 * w01)))``, then
    round-half-even and clip; bit-exact with the reference on the CPU.
    Each fma is a float64 multiply-add rounded to f32, exact wherever
    ``needs_fma`` is False; the pixels in ``grid.rounded`` are then taken
    again through ``fma_f32``.  ``bias`` (float grids only): a float32
    tensor broadcasting against the (..., N, C) sum, added to the f32 sum
    in f32 before the rounding, as the reference adds it after its fma
    chain (resample.py:119-120).  Fixed grids: 2^15 int weights,
    ``(acc + 2^14) >> 15``, clip.
    """
    ws = [w[:, None] for w in (grid.w00, grid.w01, grid.w10, grid.w11)]
    if grid.is_float:
        acc = (p01 * ws[1]).float()
        for p, w in ((p00, ws[0]), (p10, ws[2]), (p11, ws[3])):
            acc = (p * w + acc).float()
        idx = grid.rounded
        if idx.numel():
            acc.index_copy_(-2, idx, _fma_chain(
                *(p.index_select(-2, idx) for p in (p00, p01, p10, p11)),
                [w[idx] for w in ws]))
        if bias is not None:
            acc = acc + bias.float()
        return torch.round(acc).clamp_(0, 255).to(torch.uint8)
    if bias is not None:
        raise NotImplementedError(
            "bias is only supported on float-weight grids")
    acc = (p00.int() * ws[0] + p01.int() * ws[1]
           + p10.int() * ws[2] + p11.int() * ws[3])
    return ((acc + _ROUND) >> COEF_BITS).clamp_(0, 255).to(torch.uint8)


def pair_bias(bias_b: torch.Tensor | None):
    """The (N, 2) bias of a stacked (a, b) pair that adds ``bias_b``, a
    destination-shaped float32 map, to channel b alone (adding 0.0 leaves
    channel a's sum as it is), or None."""
    if bias_b is None:
        return None
    b = bias_b.reshape(-1).float()
    return torch.stack([torch.zeros_like(b), b], dim=-1)


def bilinear_gather(img: torch.Tensor, grid: ResampleGrid,
                    bias=None) -> torch.Tensor:
    """Resample a (T, Hs, Ws, C) uint8 batch through ``grid``.

    Returns (T, H, W, C) uint8 with (H, W) = ``grid.dst_shape``.
    ``bias``: as ``combine_taps``'s, (N, C) or (N, 1) for N = H * W.
    """
    T, Hs, Ws, C = img.shape
    if (Ws, Hs) != grid.src_size:
        raise ValueError(f"image {(Ws, Hs)} does not match grid source "
                         f"{grid.src_size}")
    flat = img.reshape(T, Hs * Ws, C)
    taps = [flat.index_select(1, grid.base + off)
            for off in (0, 1, Ws, Ws + 1)]
    out = combine_taps(*taps, grid, bias=bias)
    return out.reshape(T, *grid.dst_shape, C)


def bilinear_gather_pair(a: torch.Tensor, b: torch.Tensor,
                         grid: ResampleGrid, bias_b=None) -> tuple:
    """Resample two single-channel uint8 images, (Hs, Ws) or (T, Hs, Ws)
    each, through the same grid: exactly the taps, weights and arithmetic
    of two ``bilinear_gather`` calls, gathered once as two channels.  The
    reference's u32 byte packing of the pair (resample.py:146-189) is a TPU
    gather-count device.

    ``bias_b`` (float grids only): a destination-shaped float32 map added
    to channel b's sum before the rounding.  The 'turbo' pipeline passes
    128 * (1 - sum of the weights), so that a channel whose black encodes
    as 128 (LAB-B) reads 128 where the grid samples outside the source
    (out-of-bounds taps carry weight 0)."""
    if a.shape != b.shape or a.dim() not in (2, 3):
        raise ValueError(f"expected two (H, W) or (T, H, W) images of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    pair = torch.stack([a, b], dim=-1)
    out = bilinear_gather(pair if a.dim() == 3 else pair[None], grid,
                          bias=pair_bias(bias_b))
    if a.dim() == 2:
        out = out[0]
    return out[..., 0].contiguous(), out[..., 1].contiguous()
