"""The attempt-1 lane-pixel filter stage on (T, H, W) channel batches.

Port of the bilateral composition ``filter_stage_v2``
(lane_tracker_tpu/kernels/filter_stage2.py:1100-1154), which computes the
same binary as ``filter_lane_points_channels`` (ops/filters.py:62-153):

    tophat29(R) -> tophat55(B) with riders thr(tophat_R, ksize_r, C_r) and,
    with mask_noise, keep(B, ksize_noise, C_noise, noise_thresh)
    -> thr(tophat_B, ksize_b, C_b) merged with R and keep, 5x5 open,
    packed row prefixes.

Each arrow is one of the three kernels in kernels/filter_stage.py.  The
'neighborhood' filter of the second attempt is the next slice.
"""

from __future__ import annotations

import torch

from lane_tracker_tpu_torch.kernels.filter_stage import (
    thr_merge_open,
    tophat_ellipse,
    tophat_riders,
)
from lane_tracker_tpu_torch.ops.integrals import RowPrefixes
from lane_tracker_tpu_torch.tracker.config import FilterConfig


def filter_stage(rgb_r: torch.Tensor, lab_b: torch.Tensor,
                 f: FilterConfig) -> tuple[torch.Tensor, RowPrefixes]:
    """(binary, prefixes) of the bilateral filter for (T, H, W) uint8
    R and LAB-B channels."""
    if f.filter_type != "bilateral":
        raise NotImplementedError(
            f"filter_type {f.filter_type!r}: only the attempt-1 'bilateral' "
            "filter is ported; the second attempt's 'neighborhood' filter "
            "is the next slice")
    r_feat = tophat_ellipse(rgb_r, f.tophat_r)
    riders = [(r_feat, f.ksize_r, f.C_r, -1)]
    if f.mask_noise:
        riders.append((lab_b, f.ksize_noise, f.C_noise, f.noise_thresh))
    outs = tophat_riders(lab_b, f.tophat_b, riders)
    b_feat, r_th = outs[0], outs[1]
    keep = outs[2] if f.mask_noise else None
    return thr_merge_open(r_th, b_feat, f.ksize_b, f.C_b, keep,
                          open_k=f.open_k)
