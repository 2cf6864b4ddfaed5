# Frozen copy of lane_tracker_tpu_torch/ops/integrals.py:1-58 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
"""Packed row prefix sums and interval moments.

Port of lane_tracker_tpu/ops/integrals.py:38-120.  Per image row the
packed prefix at position X holds ``(x_sum << shift) | count`` of the
nonzero pixels with column < X, over X = 0..W; an interval [lo, hi) then
yields its count and x-sum from one difference.  The reference builds the
prefixes with a bf16 matmul against a triangular ones matrix (a TPU MXU
device); here it is an int32 cumsum, exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RowPrefixes(NamedTuple):
    packed: torch.Tensor  # (..., H, W+1) int32 — (x-sum << shift) | count


def _count_shift(W: int) -> int:
    """Bit width of the count field (counts go up to W inclusive)."""
    shift = (W + 1).bit_length()
    if (W * (W - 1) // 2) << shift >= 2**31:
        raise ValueError(f"packed row prefixes overflow int32 at W={W}")
    return shift


def build_row_prefixes(binary: torch.Tensor) -> RowPrefixes:
    """Packed exclusive prefix count/x-sum per row of a (..., H, W)
    binary uint8 image."""
    W = binary.shape[-1]
    shift = _count_shift(W)
    xs = torch.arange(W, dtype=torch.int32, device=binary.device)
    word = torch.where(binary > 0, (xs << shift) | 1, 0).to(torch.int32)
    pref = binary.new_zeros(binary.shape[:-1] + (W + 1,), dtype=torch.int32)
    pref[..., 1:] = torch.cumsum(word, dim=-1, dtype=torch.int32)
    return RowPrefixes(packed=pref)


def interval_moments(pref: RowPrefixes, x_lo, x_hi, row_valid):
    """Per-row (count, x-sum) of nonzero pixels with x in [x_lo, x_hi).

    x_lo/x_hi: (..., H) int32 (clipped internally); row_valid: (..., H)
    bool; ``pref.packed`` is (..., H, W+1).
    """
    Wp1 = pref.packed.shape[-1]
    shift = _count_shift(Wp1 - 1)
    lo = x_lo.clamp(0, Wp1 - 1)
    hi = torch.maximum(x_hi.clamp(0, Wp1 - 1), lo)
    p_hi = torch.gather(pref.packed, -1, hi.long().unsqueeze(-1)).squeeze(-1)
    p_lo = torch.gather(pref.packed, -1, lo.long().unsqueeze(-1)).squeeze(-1)
    diff = p_hi - p_lo
    n = diff & ((1 << shift) - 1)
    sx = diff >> shift
    valid = row_valid.to(torch.int32)
    return n * valid, sx * valid
