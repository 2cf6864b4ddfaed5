"""Tile-structured resampling: slab reads + one-hot contractions.

Port of lane_tracker_tpu/kernels/resample_rowmm.py, the resampler of
``LaneTracker(latency_mode=True)``.  Real undistortion and bird's-eye maps
are smooth, so the source pixels feeding a 32-column tile of one
destination row lie in a small source rectangle (the shipped warp reads 2
source rows a destination row; the undistort up to 5).  Per (row, tile):

1. one slab of (R + 1, omega) source pixels, read for every tile of the
   grid in one indexed gather (``_slabs``);
2. each of the four bilinear taps selected inside the slab by a one-hot
   contraction: (R * (omega - 1)) x tile matrices with one 1 a column,
   bf16 on the card with float32 accumulation, float32 on the CPU (as the
   reference, resample_rowmm.py:164-165).  Every output sums exactly one
   nonzero term of a value 0..255 (exact in bf16), so the taps equal the
   per-pixel gather's bit for bit, and ``resample.combine_taps`` applies
   the grid's own weights: outputs are ``bilinear_gather``'s and
   ``bilinear_gather_pair``'s exactly.

The contraction is a plain batched matrix product (``torch.einsum``), as
in the reference, where it is an XLA einsum and no Pallas kernel.

``build_rowmm`` is host numpy copied from the reference
(resample_rowmm.py:79-139; tests/test_torch_rowmm.py pins its output
equal); it returns None where a grid has no tile structure (a tile's
source rows span more than ``max_rows`` or its columns more than
``max_window``), and the per-pixel gather stays, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lane_tracker_tpu_torch.kernels.resample import (
    ResampleGrid,
    combine_taps,
    pair_bias,
)


class RowMMGrid(nn.Module):
    """The tile structure of one ResampleGrid, as buffers.

    iy0:    (Hd, nT) int32, the first source row of each tile's slab;
    starts: (Hd, nT) int32, its first source column;
    onehot: (Hd, nT, R * (omega - 1), tile) bf16, the tap-selection
            matrices: column i holds one 1 at r * (omega - 1) + k, where
            (r, k) locate destination pixel i's top-left tap in the slab.
    src_size (Ws, Hs), dst_size (Wd, Hd) and meta (R, omega, tile, nT,
    Wp) are the reference's static fields.
    """

    def __init__(self, iy0, starts, onehot, src_size, dst_size, meta):
        super().__init__()
        self.register_buffer("iy0", torch.as_tensor(iy0, dtype=torch.int32))
        self.register_buffer("starts",
                             torch.as_tensor(starts, dtype=torch.int32))
        self.register_buffer("onehot", onehot)
        self.src_size = tuple(int(v) for v in src_size)
        self.dst_size = tuple(int(v) for v in dst_size)
        self.meta = tuple(int(v) for v in meta)

    def copy_to(self, device) -> "RowMMGrid":
        """A new RowMMGrid with a copy of every buffer on ``device``."""
        return RowMMGrid(*(b.to(device, copy=True)
                           for b in (self.iy0, self.starts, self.onehot)),
                         self.src_size, self.dst_size, self.meta)


def build_rowmm(grid: ResampleGrid, tile: int = 32, max_rows: int = 8,
                max_window: int = 160) -> RowMMGrid | None:
    """The tile structure of ``grid`` (host numpy, the reference's
    build_rowmm), its buffers on the CPU; None if it has none."""
    Ws, Hs = grid.src_size
    Hd, Wd = grid.dst_shape
    base = grid.base.cpu().numpy().reshape(Hd, Wd)
    by = (base // Ws).astype(np.int64)
    bx = (base - by * Ws).astype(np.int64)

    nT = -(-Wd // tile)
    pad_x = nT * tile - Wd
    if pad_x:
        # Padded destination columns replicate the edge selection; they
        # are sliced off after the contraction.
        bx = np.pad(bx, ((0, 0), (0, pad_x)), mode="edge")
        by = np.pad(by, ((0, 0), (0, pad_x)), mode="edge")
    bxt = bx.reshape(Hd, nT, tile)
    byt = by.reshape(Hd, nT, tile)

    R = int((byt.max(axis=2) - byt.min(axis=2)).max()) + 1
    if R > max_rows:
        return None
    # Slabs read rows iy0 .. iy0 + R (R + 1 rows; the last feeds the lower
    # taps).  base is clipped to by <= Hs - 2, so slabs fit after clamping
    # iy0, and row offsets stay within [0, R - 1].
    iy0 = np.minimum(byt.min(axis=2), Hs - 1 - R)
    r_off = byt - iy0[:, :, None]
    assert r_off.min() >= 0 and r_off.max() <= R - 1

    Wp = Ws + 2  # bx + 1 <= Ws - 1 is real data; the pad is never selected
    span = int((bxt.max(axis=2) - bxt.min(axis=2)).max()) + 2
    omega = span
    for _ in range(4):  # starts depend on omega via the right-edge clamp
        starts = np.clip(bxt.min(axis=2), 0, Wp - omega)
        need = int((bxt.max(axis=2) - starts).max()) + 2
        if need <= omega:
            break
        omega = need
    else:
        return None
    if omega > max_window:
        return None
    offs = bxt - starts[:, :, None]
    assert offs.min() >= 0 and offs.max() <= omega - 2

    om1 = omega - 1
    onehot = torch.zeros((Hd, nT, R * om1, tile), dtype=torch.bfloat16)
    yy, tt, ii = np.meshgrid(np.arange(Hd), np.arange(nT), np.arange(tile),
                             indexing="ij")
    onehot[torch.from_numpy(yy), torch.from_numpy(tt),
           torch.from_numpy(r_off * om1 + offs), torch.from_numpy(ii)] = 1.0
    return RowMMGrid(iy0.astype(np.int32), starts.astype(np.int32), onehot,
                     src_size=(Ws, Hs), dst_size=(Wd, Hd),
                     meta=(R, omega, tile, nT, Wp))


def _slabs(planes: torch.Tensor, mm: RowMMGrid) -> torch.Tensor:
    """Every tile's (R + 1, omega) source slab of (P, Hs, Ws) uint8
    planes, in one indexed gather: (P, Hd, nT, R + 1, omega)."""
    R, omega, _, _, Wp = mm.meta
    P, Hs, Ws = planes.shape
    if (Ws, Hs) != mm.src_size:
        raise ValueError(f"planes {(Ws, Hs)} do not match the grid source "
                         f"{mm.src_size}")
    x = F.pad(planes, (0, Wp - Ws, 0, 1)).reshape(P, -1)
    dev = planes.device
    rows = mm.iy0.long()[..., None] + torch.arange(R + 1, device=dev)
    cols = mm.starts.long()[..., None] + torch.arange(omega, device=dev)
    idx = rows[..., :, None] * Wp + cols[..., None, :]
    return x[:, idx]


def _taps_rowmm(planes: torch.Tensor, mm: RowMMGrid):
    """The four bilinear taps (p00, p01, p10, p11) of every plane:
    4 x (P, Hd, Wd) float32 holding the gather's uint8 values exactly.

    planes: (P, Hs, Ws) uint8 source images sharing the grid."""
    R, omega, tile, nT, _ = mm.meta
    Wd, Hd = mm.dst_size
    P = planes.shape[0]
    win = _slabs(planes, mm)
    om1 = omega - 1
    # bf16 x bf16 with float32 accumulation on the tensor cores on the
    # card (the product's bf16 result is exact: one nonzero term of
    # 0..255); float32 on the CPU, as the reference there.
    cdt = torch.bfloat16 if planes.is_cuda else torch.float32
    oh = mm.onehot.to(cdt)

    def contract(r0, k0):
        w = win[..., r0:r0 + R, k0:k0 + om1].reshape(P, Hd, nT, R * om1)
        t = torch.einsum("pytk,ytki->pyti", w.to(cdt), oh)
        return t.reshape(P, Hd, nT * tile)[:, :, :Wd].float()

    return (contract(0, 0), contract(0, 1), contract(1, 0), contract(1, 1))


def _combine_planes(planes: torch.Tensor, grid: ResampleGrid,
                    mm: RowMMGrid, bias=None) -> torch.Tensor:
    """(P, Hd, Wd) uint8: ``combine_taps`` of each plane's taps, the
    planes as the channel axis; ``bias`` as ``combine_taps``'s, (N, P)."""
    P = planes.shape[0]
    Hd, Wd = grid.dst_shape
    taps = [t.reshape(P, Hd * Wd).T for t in _taps_rowmm(planes, mm)]
    out = combine_taps(*taps, grid, bias=bias)  # (N, P)
    return out.T.reshape(P, Hd, Wd)


def gather_planes_rowmm(planes: torch.Tensor, grid: ResampleGrid,
                        mm: RowMMGrid, biases=None) -> torch.Tensor:
    """Resample a (P, Hs, Ws) uint8 stack of planes through one grid in a
    single slab pass: plane p's output equals ``bilinear_gather`` of it,
    bit for bit.  ``biases``: None, or one destination-shaped float32 map
    or None a plane (float grids only), added as ``combine_taps``'s."""
    bias = None
    if biases is not None and any(b is not None for b in biases):
        n = grid.base.numel()
        bias = torch.stack([
            torch.zeros(n, device=planes.device) if b is None
            else b.reshape(-1).float() for b in biases], dim=-1)
    return _combine_planes(planes, grid, mm, bias)


def bilinear_gather_rowmm(img: torch.Tensor, grid: ResampleGrid,
                          mm: RowMMGrid) -> torch.Tensor:
    """``bilinear_gather(img, grid)`` bit for bit: img is (T, Hs, Ws, C)
    uint8, the result (T, Hd, Wd, C)."""
    T, Hs, Ws, C = img.shape
    planes = img.permute(0, 3, 1, 2).reshape(T * C, Hs, Ws)
    out = _combine_planes(planes, grid, mm)
    return out.reshape(T, C, *grid.dst_shape).permute(0, 2, 3, 1).contiguous()


def bilinear_gather_pair_rowmm(a: torch.Tensor, b: torch.Tensor,
                               grid: ResampleGrid, mm: RowMMGrid,
                               bias_b=None) -> tuple:
    """``bilinear_gather_pair(a, b, grid, bias_b)`` bit for bit, for two
    (Hs, Ws) or (T, Hs, Ws) uint8 images of one shape."""
    if a.shape != b.shape or a.dim() not in (2, 3):
        raise ValueError(f"expected two (H, W) or (T, H, W) images of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    src = torch.stack([a, b], dim=-1)
    if a.dim() == 2:
        src = src[None]
    T, Hs, Ws, _ = src.shape
    planes = src.permute(0, 3, 1, 2).reshape(T * 2, Hs, Ws)
    # Planes run (frame, channel): the pair's (N, 2) bias once a frame.
    bias = None if bias_b is None else pair_bias(bias_b).repeat(1, T)
    out = _combine_planes(planes, grid, mm, bias).reshape(
        T, 2, *grid.dst_shape)
    ra, rb = out[:, 0].contiguous(), out[:, 1].contiguous()
    return (ra[0], rb[0]) if a.dim() == 2 else (ra, rb)
