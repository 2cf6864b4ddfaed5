"""The fused channel stage: a channel's tophat and its bilateral threshold(s)
in one kernel, so the tophat image never goes to device memory.

Port of scripts/channel_fused_postmortem.py.  The JAX package drives this
path through scripts/mosaic_probe7.py and mosaic_probe8.py, which check it
against the unfused chain and time both at several block heights; the
tracker itself runs the unfused kernels (kernels/filter_stage.py).

* ``channel_stage``     <- ``channel_stage_pallas2`` (:379): th =
  ``cross_threshold(tophat(x, kt), kb, C)``, and with ``noise=(kn, Cn,
  nthr)`` also the keep-mask ``(x < nthr) | cross_threshold(x, kn, Cn)``.
* ``channel_stage_pyr`` <- ``channel_stage_pyr_pallas2`` (:264): the same
  function without the noise mask.  The TPU kernel differs only in how it
  sums windows (pyramids instead of band matmuls) and in its full-height
  blocks, so it launches the same CUDA kernel with the same tile plan; it
  counts its own launches.

Both take (T, H, W) or (H, W) uint8.  On CUDA tensors they launch
``lt_channel_stage`` (csrc/channel_stage.cu, built at first use by
kernels/build.py) on the current stream, or raise; on CPU tensors they run
the plain twin, ``tophat_ellipse`` then ``cross_threshold``
(ops/morphology.py, ops/threshold.py).  A CTA covers a tile of 64 to 256
columns by ``block`` rows; the host plans the tile (``tile``): by default
the one of the fewest estimated shared-memory accesses that fits a CTA,
else ``block`` rows clamped to the image height and to what fits, at the
width that suits them.  The twins ignore ``block``.
"""

from __future__ import annotations

import torch

from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.kernels.filter_stage import (
    _call,
    _on_cuda,
    _runs_table,
    _tophat_k,
)
from lane_tracker_tpu_torch.ops.morphology import tophat_ellipse
from lane_tracker_tpu_torch.ops.threshold import cross_threshold

_SRC = "lane_tracker_tpu_torch/csrc/channel_stage.cu"
SOURCE = {"channel_stage": _SRC, "channel_stage_pyr": _SRC}
_TPU = "scripts/channel_fused_postmortem.py:"
REPLACES = {"channel_stage": _TPU + "379", "channel_stage_pyr": _TPU + "264"}
LAUNCHES = {name: 0 for name in REPLACES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tile(H: int, W: int, kt: int, kb: int, kn: int = 0,
         block: int | None = None) -> tuple:
    """(columns, rows) of the tile a launch on an H x W frame uses, for
    tophat kt, threshold kb and noise arms kn (0: no noise): the planned
    tile, or ``block`` rows clamped to H and to what fits the current
    CUDA device's shared memory."""
    want = _block(block)
    runs = _runs_table(_tophat_k(kt))
    packed = int(load_library().lt_channel_stage_plan(
        runs.ctypes.data, len(runs), int(kt), int(kb), int(kn), int(H),
        int(W), want))
    if packed < 0:
        raise RuntimeError(f"no tile of the fused channel stage (kt={kt}, "
                           f"kb={kb}, kn={kn}) fits this device's shared "
                           "memory")
    return packed >> 16, packed & 0xFFFF


def _block(block) -> int:
    """The entry's block argument: 0 for the planned tile."""
    if block is None:
        return 0
    if int(block) < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    return int(block)


def channel_stage_plain(img: torch.Tensor, kt: int, kb: int, C: int, *,
                        noise: tuple | None = None, block: int | None = None):
    """Plain twin of ``channel_stage`` (``block`` is ignored)."""
    del block
    th = cross_threshold(tophat_ellipse(img, int(kt)), int(kb), int(C))
    if noise is None:
        return th
    kn, Cn, nthr = (int(v) for v in noise)
    return th, cross_threshold(img, kn, Cn, nthr)


def _launch(img: torch.Tensor, kt, kb, C, noise, block):
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    T, H, W = x.shape
    kn, Cn, nthr = (int(v) for v in noise) if noise else (0, 0, -1)
    if noise and kn < 1:
        raise ValueError(f"noise needs kn >= 1, got {noise}")
    want = _block(block)
    th = torch.empty_like(x)
    keep = torch.empty_like(x) if noise else None
    runs = _runs_table(_tophat_k(kt))
    _call(x.device, load_library().lt_channel_stage,
          x.data_ptr(), th.data_ptr(),
          None if keep is None else keep.data_ptr(), runs.ctypes.data,
          len(runs), int(kt), int(kb), int(C), kn, Cn, nthr, want, T, H, W)
    if squeeze:
        th = th[0]
        keep = None if keep is None else keep[0]
    return th if keep is None else (th, keep)


def _is_cuda(img: torch.Tensor) -> bool:
    if img.dim() not in (2, 3):
        raise ValueError(
            f"expected (T, H, W) or (H, W), got {tuple(img.shape)}")
    return _on_cuda(img[None] if img.dim() == 2 else img)


def channel_stage(img: torch.Tensor, kt: int, kb: int, C: int, *,
                  noise: tuple | None = None, block: int | None = None):
    """``cross_threshold(tophat(img, kt), kb, C)`` as 0/255; with ``noise
    = (kn, Cn, nthr)`` returns ``(th, keep)``, keep the noise keep-mask
    ``(img < nthr) | cross_threshold(img, kn, Cn)``."""
    if not _is_cuda(img):
        return channel_stage_plain(img, kt, kb, C, noise=noise)
    out = _launch(img, kt, kb, C, noise, block)
    LAUNCHES["channel_stage"] += 1
    return out


def channel_stage_pyr_plain(img: torch.Tensor, kt: int, kb: int, C: int, *,
                            block: int | None = None) -> torch.Tensor:
    """Plain twin of ``channel_stage_pyr`` (``block`` is ignored)."""
    return channel_stage_plain(img, kt, kb, C)


def channel_stage_pyr(img: torch.Tensor, kt: int, kb: int, C: int, *,
                      block: int | None = None) -> torch.Tensor:
    """``cross_threshold(tophat(img, kt), kb, C)`` as 0/255: the same
    kernel and tile plan as ``channel_stage`` without the noise mask."""
    if not _is_cuda(img):
        return channel_stage_pyr_plain(img, kt, kb, C)
    out = _launch(img, kt, kb, C, None, block)
    LAUNCHES["channel_stage_pyr"] += 1
    return out
