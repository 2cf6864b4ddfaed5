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
  5x5 open, packed row prefixes.  With mask_noise (the XLA chain of
  ops/filters.py:94-153; no Pallas kernel has it) the merge also takes the
  noise keep-mask ``(B < noise_thresh) | thr(B, ksize_noise, C_noise)``,
  the standalone threshold kernel's noise route.

Each arrow is one of the kernels in kernels/filter_stage.py.
``filter_lane_points`` (ops/filters.py:156) is the same stage on warped
RGB frames, LAB-B by the LUT chain.
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
from lane_tracker_tpu_torch.ops.color import rgb2lab_b_u8
from lane_tracker_tpu_torch.ops.integrals import RowPrefixes
from lane_tracker_tpu_torch.tracker.config import FilterConfig


def neighborhood_stage(rgb_r: torch.Tensor, lab_b: torch.Tensor,
                       ksize_r: int = 15, C_r: int = 5, ksize_b: int = 35,
                       C_b: int = 5, open_k: int = 5,
                       noise: tuple | None = None
                       ) -> tuple[torch.Tensor, RowPrefixes]:
    """(binary, prefixes) of the 'neighborhood' filter: adaptive mean
    thresholds on the raw channels, pixel must beat its block mean by more
    than C (lane_tracker.py:216-218), then merge and open.  ``noise`` =
    (ksize_noise, C_noise, noise_thresh) also masks the merge with the
    noise keep-mask (lane_tracker.py:221-231)."""
    r_th = adaptive_mean(rgb_r, ksize_r, -C_r)
    b_th = adaptive_mean(lab_b, ksize_b, -C_b)
    keep = None if noise is None else bilateral_threshold(lab_b, *noise)
    return merge_open(r_th, b_th, keep, open_k=open_k)


def filter_stage(rgb_r: torch.Tensor, lab_b: torch.Tensor,
                 f: FilterConfig) -> tuple[torch.Tensor, RowPrefixes]:
    """(binary, prefixes) of the filter ``f.filter_type`` for (T, H, W)
    uint8 R and LAB-B channels."""
    if f.filter_type == "neighborhood":
        noise = ((f.ksize_noise, f.C_noise, f.noise_thresh) if f.mask_noise
                 else None)
        return neighborhood_stage(rgb_r, lab_b, f.ksize_r, f.C_r, f.ksize_b,
                                  f.C_b, f.open_k, noise)
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


def filter_lane_points(warped_rgb: torch.Tensor,
                       filter_type: str = "bilateral", ksize_r: int = 25,
                       C_r: int = 8, ksize_b: int = 35, C_b: int = 5,
                       mask_noise: bool = False, ksize_noise: int = 65,
                       C_noise: int = 10, noise_thresh: int = 135
                       ) -> torch.Tensor:
    """The filter stage's 0/255 binary of a warped (H, W, 3) or (T, H, W,
    3) uint8 RGB frame: ``filter_stage`` of its R channel and its LAB-B
    (the LUT chain, ``rgb2lab_b_u8``), with the reference's structuring
    elements (29, 55, open 5).  The reference's defaults."""
    f = FilterConfig(filter_type=filter_type, ksize_r=ksize_r, C_r=C_r,
                     ksize_b=ksize_b, C_b=C_b, mask_noise=mask_noise,
                     noise_thresh=noise_thresh, ksize_noise=ksize_noise,
                     C_noise=C_noise)
    frames = warped_rgb if warped_rgb.dim() == 4 else warped_rgb[None]
    binary, _ = filter_stage(frames[..., 0].contiguous(),
                             rgb2lab_b_u8(frames), f)
    return binary if warped_rgb.dim() == 4 else binary[0]
