"""The attempt-1 filter stage's three kernels: CUDA wrappers + plain twins.

Each public function takes (T, H, W) uint8 tensors.  On CUDA tensors it
launches the hand-written sm_90a kernel in csrc/filter_stage.cu (built at
first use, kernels/build.py) on the current stream, or raises; on CPU
tensors it runs the plain PyTorch twin defined beside it.  There is no
fallback between the two: the device of the inputs decides.  Every CUDA
launch adds one to ``LAUNCHES[<function name>]``; twins never count.

Replaced TPU kernels (lane_tracker_tpu/kernels/filter_stage2.py):

* ``tophat_ellipse``  <- ``tophat_pallas2`` (white tophat x - open(x) with
  OpenCV's k x k ellipse; k=29 on warped R, k=55 on LAB-B).
* ``tophat_riders``   <- ``tophat_riders_pallas2`` (the tophat plus one
  bilateral cross threshold per rider, each on its own input).  The TPU
  kernel fuses the riders to hide their MXU band matmuls under the tophat's
  VPU sweeps; here the riders are separate launches of the cross-threshold
  kernel, which reads four prefix-sum entries per pixel at any arm length.
* ``thr_merge_open``  <- ``thr_merge_open_pallas2`` (B cross threshold,
  (R | B) & keep, 5x5 elliptical open, packed row prefixes).

Bounds on the H100 and what the design does about them are noted at the
top of csrc/filter_stage.cu: the kernels are shared-memory bound, so the
morphology reads two entries of a pow2 window pyramid per SE row and the
threshold reads prefix sums.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.ops.integrals import (
    RowPrefixes,
    _count_shift,
    build_row_prefixes,
)
from lane_tracker_tpu_torch.ops.morphology import (
    ellipse_runs,
    open_ellipse,
)
from lane_tracker_tpu_torch.ops.morphology import (
    tophat_ellipse as _tophat_plain,
)
from lane_tracker_tpu_torch.ops.threshold import cross_threshold

SOURCE = "lane_tracker_tpu_torch/csrc/filter_stage.cu"
REPLACES = {
    "tophat_ellipse": "lane_tracker_tpu/kernels/filter_stage2.py:469",
    "tophat_riders": "lane_tracker_tpu/kernels/filter_stage2.py:975",
    "thr_merge_open": "lane_tracker_tpu/kernels/filter_stage2.py:1497",
}
LAUNCHES = {name: 0 for name in REPLACES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*imgs: torch.Tensor) -> bool:
    """Validate (T, H, W) uint8 inputs of one shape; True for the CUDA
    kernel, False for the plain twin (all on the CPU)."""
    shape = imgs[0].shape
    for x in imgs:
        if x.dtype != torch.uint8 or x.dim() != 3 or x.shape != shape:
            raise ValueError(
                f"expected (T, H, W) uint8 tensors of one shape, got "
                f"{tuple(x.shape)} {x.dtype}")
    devices = {x.device for x in imgs}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for x in imgs:
        if not x.is_contiguous():
            raise ValueError("CUDA kernel inputs must be contiguous")
    return True


@functools.lru_cache(maxsize=None)
def _runs_table(ksize: int) -> np.ndarray:
    """ellipse_runs(ksize) as int32 rows of (dy, lo, hi) for the kernels."""
    return np.asarray([(dy, lo, hi) for dy, (lo, hi) in ellipse_runs(ksize)],
                      dtype=np.int32)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def _launch_tophat(img: torch.Tensor, ksize: int) -> torch.Tensor:
    T, H, W = img.shape
    out = torch.empty_like(img)
    scratch = torch.empty_like(img)
    runs = _runs_table(int(ksize))
    _check(load_library().lt_tophat(
        img.data_ptr(), out.data_ptr(), scratch.data_ptr(), runs.ctypes.data,
        len(runs), int(ksize), T, H, W, _stream()), "lt_tophat")
    return out


def _launch_threshold(img: torch.Tensor, k: int, C: int,
                      noise_thresh: int) -> torch.Tensor:
    T, H, W = img.shape
    out = torch.empty_like(img)
    _check(load_library().lt_cross_threshold(
        img.data_ptr(), out.data_ptr(), T, H, W, int(k), int(C),
        int(noise_thresh), _stream()), "lt_cross_threshold")
    return out


# ---- tophat_ellipse ------------------------------------------------------


def tophat_ellipse_plain(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Plain twin of ``tophat_ellipse``."""
    return _tophat_plain(img, ksize)


def tophat_ellipse(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """White tophat img - open(img) with OpenCV's ksize x ksize ellipse."""
    if not _on_cuda(img):
        return tophat_ellipse_plain(img, ksize)
    out = _launch_tophat(img, ksize)
    LAUNCHES["tophat_ellipse"] += 1
    return out


# ---- tophat_riders -------------------------------------------------------


def tophat_riders_plain(img, ksize, riders):
    """Plain twin of ``tophat_riders``."""
    return (_tophat_plain(img, ksize),
            *(cross_threshold(src, k, C, nt) for src, k, C, nt in riders))


def tophat_riders(img: torch.Tensor, ksize: int, riders) -> tuple:
    """``(tophat(img), thr(src_0), ..., thr(src_n-1))`` for riders
    ``(src, k, C, noise_thresh)``: each a bilateral cross threshold of its
    own input (noise_thresh = -1), or with ``noise_thresh >= 0`` the noise
    keep-mask ``(src < noise_thresh) | thr(src)``."""
    if not _on_cuda(img, *(r[0] for r in riders)):
        return tophat_riders_plain(img, ksize, riders)
    outs = (_launch_tophat(img, ksize),
            *(_launch_threshold(src, k, C, nt) for src, k, C, nt in riders))
    LAUNCHES["tophat_riders"] += 1
    return outs


# ---- thr_merge_open ------------------------------------------------------


def thr_merge_open_plain(r_th, b_feat, kb, Cb, keep=None, open_k=5):
    """Plain twin of ``thr_merge_open``."""
    merged = (r_th > 0) | (cross_threshold(b_feat, kb, Cb) > 0)
    if keep is not None:
        merged = merged & (keep > 0)
    binary = open_ellipse(torch.where(merged, 255, 0).to(torch.uint8), open_k)
    return binary, build_row_prefixes(binary)


def thr_merge_open(r_th: torch.Tensor, b_feat: torch.Tensor, kb: int,
                   Cb: int, keep: torch.Tensor | None = None,
                   open_k: int = 5):
    """open_k ellipse opening of ``((r_th | thr(b_feat, kb, Cb)) & keep)``
    as 0/255, plus its packed exclusive row prefixes (T, H, W + 1) int32
    with ``shift = (W + 1).bit_length()``.  Returns (binary, RowPrefixes)."""
    imgs = (r_th, b_feat) if keep is None else (r_th, b_feat, keep)
    if not _on_cuda(*imgs):
        return thr_merge_open_plain(r_th, b_feat, kb, Cb, keep, open_k)
    T, H, W = r_th.shape
    out = torch.empty_like(r_th)
    pref = torch.empty((T, H, W + 1), dtype=torch.int32, device=r_th.device)
    scratch0 = torch.empty_like(r_th)
    scratch1 = torch.empty_like(r_th)
    runs = _runs_table(int(open_k))
    _check(load_library().lt_thr_merge_open(
        r_th.data_ptr(), b_feat.data_ptr(),
        None if keep is None else keep.data_ptr(),
        out.data_ptr(), pref.data_ptr(), scratch0.data_ptr(),
        scratch1.data_ptr(), runs.ctypes.data, len(runs), int(open_k),
        T, H, W, int(kb), int(Cb), _count_shift(W), _stream()),
        "lt_thr_merge_open")
    LAUNCHES["thr_merge_open"] += 1
    return out, RowPrefixes(packed=pref)
