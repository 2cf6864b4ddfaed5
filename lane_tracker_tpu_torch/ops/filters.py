"""The lane-pixel filter stage on (T, H, W) channel batches.

Port of the stage-kernel compositions of
lane_tracker_tpu/kernels/filter_stage2.py, which compute the same binary
as ``filter_lane_points_channels`` (ops/filters.py:62-153):

* 'bilateral' (attempt 1), ``filter_stage_v2`` (l.1100-1154):

      tophat29(R) -> tophat55(B) with riders thr(tophat_R, ksize_r, C_r)
      and, with mask_noise, keep(B, ksize_noise, C_noise, noise_thresh)
      -> thr(tophat_B, ksize_b, C_b) merged with R and keep, 5x5 open,
      packed row prefixes;

  for ``ksize_b + 1 > 64`` the last arrow is the reference's other route,
  the standalone threshold then the merge + open.
* 'neighborhood' (the second attempt), ``neighborhood_stage_v2``
  (l.1804-1822): adaptive mean thresholds of the raw R and LAB-B, merge,
  5x5 open, packed row prefixes.

Each arrow is one of the kernels in kernels/filter_stage.py.
"""

from __future__ import annotations

import torch

from lane_tracker_tpu_torch.kernels.filter_stage import (
    adaptive_mean,
    bilateral_threshold,
    merge_open,
    thr_merge_open,
    tophat_ellipse,
    tophat_riders,
)
from lane_tracker_tpu_torch.ops.integrals import RowPrefixes
from lane_tracker_tpu_torch.tracker.config import FilterConfig


def neighborhood_stage(rgb_r: torch.Tensor, lab_b: torch.Tensor,
                       ksize_r: int = 15, C_r: int = 5, ksize_b: int = 35,
                       C_b: int = 5, open_k: int = 5
                       ) -> tuple[torch.Tensor, RowPrefixes]:
    """(binary, prefixes) of the 'neighborhood' filter: adaptive mean
    thresholds on the raw channels, pixel must beat its block mean by more
    than C (lane_tracker.py:216-218), then merge and open."""
    r_th = adaptive_mean(rgb_r, ksize_r, -C_r)
    b_th = adaptive_mean(lab_b, ksize_b, -C_b)
    return merge_open(r_th, b_th, open_k=open_k)


def filter_stage(rgb_r: torch.Tensor, lab_b: torch.Tensor,
                 f: FilterConfig) -> tuple[torch.Tensor, RowPrefixes]:
    """(binary, prefixes) of the filter ``f.filter_type`` for (T, H, W)
    uint8 R and LAB-B channels."""
    if f.filter_type == "neighborhood":
        if f.mask_noise:
            raise NotImplementedError(
                "the 'neighborhood' filter with mask_noise is not ported "
                "(no preset and no second attempt uses it)")
        return neighborhood_stage(rgb_r, lab_b, f.ksize_r, f.C_r, f.ksize_b,
                                  f.C_b, f.open_k)
    if f.filter_type != "bilateral":
        raise ValueError("filter_type must be 'bilateral' or 'neighborhood'")
    r_feat = tophat_ellipse(rgb_r, f.tophat_r)
    riders = [(r_feat, f.ksize_r, f.C_r, -1)]
    if f.mask_noise:
        riders.append((lab_b, f.ksize_noise, f.C_noise, f.noise_thresh))
    outs = tophat_riders(lab_b, f.tophat_b, riders)
    b_feat, r_th = outs[0], outs[1]
    keep = outs[2] if f.mask_noise else None
    if f.ksize_b + 1 <= 64:
        return thr_merge_open(r_th, b_feat, f.ksize_b, f.C_b, keep,
                              open_k=f.open_k)
    b_th = bilateral_threshold(b_feat, f.ksize_b, f.C_b)
    return merge_open(r_th, b_th, keep, open_k=f.open_k)
