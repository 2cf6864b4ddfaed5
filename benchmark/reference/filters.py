# Frozen copy of lane_tracker_tpu_torch/ops/filters.py:1-103 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
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

from benchmark.reference.integrals import build_row_prefixes
from benchmark.reference.morphology import open_ellipse, tophat_ellipse
from benchmark.reference.threshold import (
    adaptive_mean_threshold,
    cross_threshold,
)
from benchmark.reference.color import rgb2lab_b_u8
from benchmark.reference.integrals import RowPrefixes
from benchmark.reference.config import FilterConfig


# The plain twins of the filter kernels, frozen copies of
# lane_tracker_tpu_torch/kernels/filter_stage.py:396-399, 422-425, 448-450,
# 475-481 and 501-503 (commit 6cc3612): the reference never launches a
# kernel of the port.


def tophat_riders(img, ksize, riders):
    return (tophat_ellipse(img, ksize),
            *(cross_threshold(src, k, C, nt) for src, k, C, nt in riders))


def merge_open(r_th, b_th, keep=None, open_k=5):
    merged = (r_th > 0) | (b_th > 0)
    if keep is not None:
        merged = merged & (keep > 0)
    binary = open_ellipse(torch.where(merged, 255, 0).to(torch.uint8), open_k)
    return binary, build_row_prefixes(binary)


def thr_merge_open(r_th, b_feat, kb, Cb, keep=None, open_k=5):
    return merge_open(r_th, cross_threshold(b_feat, kb, Cb), keep, open_k)


def adaptive_mean(img, ksize, C):
    return adaptive_mean_threshold(img, ksize, C)


def bilateral_threshold(img, ksize, C, noise_thresh=-1):
    return cross_threshold(img, ksize, C, noise_thresh)


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
