"""Probe 11's kernel: chains of in-tile gathers, wrapper and twin.

Port of the Pallas kernel that ``timed``'s ``call`` launches in
scripts/mosaic_probe11.py (:44/:49), which asks what a dynamic gather inside
one (8, 128) tile costs: the gather a hand-written warp kernel would use.
An (H, W) int32 array is cut into (8, 128) tiles; in every tile, from
prev = 0, ``reps`` times ``prev = op(s + prev, li, si) & 0x7F`` with op, at
tile-local row r and column c, one of

* ``B0_plain_add``: v[r, c];
* ``G1_lane_gather``: v[r, li[r, c]] (li < 128);
* ``G2_sublane_gather``: v[si[r, c], c] (si < 8);
* ``G3_2d_gather``: G2 of G1, v[si[r, c], li[si[r, c], c]].

Indices are read modulo the tile (li & 127, si & 7) by the kernel and the
twin alike.  Integer and bit-exact.

* ``tile_gather(src, li, si, op, reps)``: on CUDA tensors one launch of
  ``lt_tile_gather`` (csrc/tile_gather.cu: the low 7 bits of each element a
  byte; B0 and G2 a thread a column, G1 a warp a row gathering through
  ``__shfl_sync``, both in one-warp CTAs with no barrier; G3 G1's warps, 8
  a tile, and one CTA barrier a rep before the sublane gather), adding one
  to ``LAUNCHES["tile_gather"]``; on CPU tensors ``tile_gather_plain``, the
  tiles as an (H/8, 8, W/128, 128) view and ``torch.gather``.
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.kernels.filter_stage import _call, _one_device

SOURCE = {"tile_gather": "lane_tracker_tpu_torch/csrc/tile_gather.cu"}
REPLACES = {"tile_gather": "scripts/mosaic_probe11.py:49"}
LAUNCHES = {name: 0 for name in REPLACES}

# The probe's array (16 sublane groups x 10 lane windows), its tile and the
# two chain lengths it times.
H, W = 128, 1280
TILE_H, TILE_W = 8, 128
REPS = (16, 64)
OPS = {"B0_plain_add": 0, "G1_lane_gather": 1, "G2_sublane_gather": 2,
       "G3_2d_gather": 3}
MASK = 0x7F


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def make_inputs(device="cpu") -> tuple:
    """The probe's inputs, drawn from ``default_rng(0)`` in its order: src
    < 2**20, then li < 128, then si < 8, all (H, W) int32."""
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, high, (H, W), np.int32)
              for high in (2 ** 20, TILE_W, TILE_H)]
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _validate(src, li, si, op, reps) -> int:
    if op not in OPS:
        raise ValueError(f"op must be one of {list(OPS)}, got {op!r}")
    if any(a.dtype != torch.int32 or a.shape != src.shape
           for a in (src, li, si)) or src.dim() != 2:
        raise ValueError("src, li and si must be (H, W) int32 of one shape")
    h, w = src.shape
    if h % TILE_H or w % TILE_W or not h or not w:
        raise ValueError(f"({h}, {w}) is not a whole number of "
                         f"({TILE_H}, {TILE_W}) tiles")
    if reps < 0:
        raise ValueError(f"reps = {reps} < 0")
    return OPS[op]


def tile_gather_plain(src: torch.Tensor, li: torch.Tensor, si: torch.Tensor,
                      op: str, reps: int) -> torch.Tensor:
    """Plain twin of ``tile_gather``."""
    code = _validate(src, li, si, op, reps)
    h, w = src.shape
    tiles = (h // TILE_H, TILE_H, w // TILE_W, TILE_W)
    s = src.view(tiles)
    lane = (li & (TILE_W - 1)).view(tiles).long()
    row = (si & (TILE_H - 1)).view(tiles).long()
    prev = torch.zeros_like(s)
    for _ in range(reps):
        v = s + prev
        if code in (1, 3):
            v = torch.gather(v, 3, lane)
        if code in (2, 3):
            v = torch.gather(v, 1, row)
        prev = v & MASK
    return prev.reshape(h, w)


def tile_gather(src: torch.Tensor, li: torch.Tensor, si: torch.Tensor,
                op: str, reps: int) -> torch.Tensor:
    """``reps`` reps of op over the (8, 128) tiles of src (H, W) int32,
    with the tile-local indices li and si: (H, W) int32."""
    code = _validate(src, li, si, op, reps)
    device = _one_device(src, li, si)
    if device.type == "cpu":
        return tile_gather_plain(src, li, si, op, reps)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not all(a.is_contiguous() for a in (src, li, si)):
        raise ValueError("CUDA kernel inputs must be contiguous")
    out = torch.empty_like(src)
    h, w = src.shape
    _call(device, load_library().lt_tile_gather,
          src.data_ptr(), li.data_ptr(), si.data_ptr(), out.data_ptr(), h, w,
          code, reps)
    LAUNCHES["tile_gather"] += 1
    return out
