"""The filter stage's kernels: CUDA wrappers + plain twins.

Each public function takes (T, H, W) uint8 tensors.  On CUDA tensors it
launches a hand-written sm_90a kernel from csrc/ (built at first use,
kernels/build.py) on its device's current stream, with that device
current, or raises; on CPU tensors it runs the plain PyTorch twin defined
beside it.  There is no fallback between the two: the device of the
inputs decides, and inputs on two devices raise before any launch.
Every CUDA launch adds one to ``LAUNCHES[<function name>]``; twins never
count.

Replaced TPU kernels (lane_tracker_tpu/kernels/filter_stage2.py), attempt 1:

* ``tophat_ellipse``  <- ``tophat_pallas2`` (white tophat x - open(x) with
  OpenCV's k x k ellipse; k=29 on warped R, k=55 on LAB-B).
* ``tophat_riders``   <- ``tophat_riders_pallas2`` (the tophat plus one
  bilateral cross threshold per rider, each on its own input).  The TPU
  kernel fuses the riders to hide their MXU band matmuls under the tophat's
  VPU sweeps; here the riders are separate launches of the cross-threshold
  kernel, which keeps running arm sums at any arm length.
* ``thr_merge_open``  <- ``thr_merge_open_pallas2`` (B cross threshold,
  (R | B) & keep, 5x5 elliptical open, packed row prefixes): the
  threshold kernel, then the open + prefix tail kernel with the merge in
  its load; two launches.

The second attempt's 'neighborhood' filter, and the bilateral filter's
route for ``ksize_b + 1 > 64``:

* ``adaptive_mean``   <- ``adaptive_mean_pallas2`` (``cv2.adaptiveThreshold``
  MEAN_C / BINARY, replicate border, odd k; csrc/adaptive_mean.cu).
* ``merge_open``      <- ``merge_open_pallas2`` ((r | b) & keep, 5x5
  elliptical open, packed row prefixes): one launch of the tail kernel
  ``lt_thr_merge_open`` ends with, the merge in its load.
* ``bilateral_threshold`` <- ``bilateral_threshold_pallas2`` (the standalone
  cross threshold, optionally the noise keep-mask; the riders' kernel).

The morphology probes (lane_tracker_tpu_torch/probes/mosaic.py; the
tracker runs neither):

* ``tophat_staged`` <- ``tophat_bf16`` of scripts/mosaic_probe5.py (the
  production tophat with bf16 or f32 compute scratch): one launch of
  ``lt_tophat``'s tile with its shared planes in bf16 or f32 bit patterns
  (2 or 4 bytes a pixel) instead of uint8.  Pixels are 0..255, exact in
  all three, so the twin is ``tophat_ellipse_plain``.
* ``dual_tophat`` <- ``build_dual``'s ``run`` of scripts/mosaic_probe10.py
  (two independent tophats in one kernel): one launch over the tiles of
  both problems, each at ``lt_tophat``'s plan for its k, against the two
  launches of two ``tophat_ellipse`` calls.

Bounds on the H100 and what the design does about them are noted at the
top of each source: the kernels are shared-memory and issue bound.  The
tophat keeps four pixels a word (min/max by Hopper's DPX on two 16-bit
lanes) and widens one plane of window min/max through the ellipse's
distinct half-widths, erode and dilate in one launch; the threshold keeps
running arm sums; the open + prefix tail keeps 32 binary pixels a word
(the open as ANDs and ORs of shifted words, the prefixes from popcounts);
the probes' tophats run the tophat's tile; the adaptive mean keeps running
sums.
``kernel_launches()`` reads the library's own count of kernel launches
(every launcher of this module's kernels adds to it).
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
from lane_tracker_tpu_torch.ops.threshold import (
    adaptive_mean_threshold,
    cross_threshold,
)

_CSRC = "lane_tracker_tpu_torch/csrc/"
SOURCE = {
    "tophat_ellipse": _CSRC + "filter_stage.cu",
    "tophat_riders": _CSRC + "filter_stage.cu",
    "thr_merge_open": _CSRC + "filter_stage.cu",
    "adaptive_mean": _CSRC + "adaptive_mean.cu",
    "merge_open": _CSRC + "filter_stage.cu",
    "bilateral_threshold": _CSRC + "filter_stage.cu",
    "tophat_staged": _CSRC + "tophat_staged.cu",
    "dual_tophat": _CSRC + "dual_tophat.cu",
}
_TPU = "lane_tracker_tpu/kernels/filter_stage2.py:"
REPLACES = {
    "tophat_ellipse": _TPU + "469",
    "tophat_riders": _TPU + "975",
    "thr_merge_open": _TPU + "1497",
    "adaptive_mean": _TPU + "1725",
    "merge_open": _TPU + "1258",
    "bilateral_threshold": _TPU + "771",
    "tophat_staged": "scripts/mosaic_probe5.py:91",
    "dual_tophat": "scripts/mosaic_probe10.py:120",
}
# Staging types of ``tophat_staged`` (beside ``tophat_ellipse``'s uint8) and
# their codes in lt_tophat_staged.
STAGING = {torch.bfloat16: 1, torch.float32: 2}
# The adaptive-mean kernel keeps row sums of k pixels in uint16 lanes
# (csrc/adaptive_mean.cu kAdaptiveMaxK): odd k up to 127 on the card.
ADAPTIVE_MEAN_MAX_K = 127
# The tophat kernels (``tophat_ellipse``, ``tophat_staged``, ``dual_tophat``)
# take odd k (OpenCV's ellipse is then symmetric about its centre row) with
# at most 64 SE rows (csrc/common.cuh kMaxRuns), in at most 40 widening
# steps (kTopMaxSteps); the threshold kernel's staged
# tile, (128 + 2k) rows of 128 + 2 round16(k) bytes, fits the 227 KB a
# block can take up to k = 128.
TOPHAT_MAX_K = 63
TOPHAT_MAX_STEPS = 40
THRESHOLD_MAX_K = 128
# The open + prefix tail takes odd k whose half-width one neighbour word of
# 32 pixels covers.
OPEN_MAX_K = 63
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
    device = _one_device(*imgs)
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


def kernel_launches() -> int:
    """Kernel launches the library's filter-stage entries have made so
    far (the C launchers count them): the difference over a call is the
    call's launches, with no profiler."""
    return int(load_library().lt_filter_stage_launches())


def _tophat_k(ksize) -> int:
    k = int(ksize)
    if k % 2 != 1 or not 1 <= k <= TOPHAT_MAX_K:
        raise ValueError(f"the tophat kernel needs an odd ksize in "
                         f"[1, {TOPHAT_MAX_K}], got {ksize}")
    return k


def _open_k(ksize) -> int:
    k = int(ksize)
    if k % 2 != 1 or not 1 <= k <= OPEN_MAX_K:
        raise ValueError(f"the open + prefix kernel needs an odd ksize in "
                         f"[1, {OPEN_MAX_K}], got {ksize}")
    return k


def _threshold_k(ksize) -> int:
    k = int(ksize)
    if not 1 <= k <= THRESHOLD_MAX_K:
        raise ValueError(f"the cross-threshold kernel needs a ksize in "
                         f"[1, {THRESHOLD_MAX_K}], got {ksize}")
    return k


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def _one_device(*tensors: torch.Tensor) -> torch.device:
    """The one device a call's tensors lie on; ValueError, before any
    launch, if they lie on several."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devices))}")
    return devices.pop()


def _call(device: torch.device, entry, *args) -> None:
    """Call the library's C launcher ``entry`` with ``args`` and, last,
    the stream, with ``device`` (the inputs') current, on its current
    stream.  The launchers read the current device (cudaGetDevice) and
    set their kernels' shared-memory attributes on it
    (cudaFuncSetAttribute), so a call on another card's tensors must make
    that card current.  Raises on a CUDA error."""
    with torch.cuda.device(device):
        _check(entry(*args, torch.cuda.current_stream(device).cuda_stream),
               entry.__name__)


def _launch_tophat(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """One launch of the tophat kernel (its scratch argument unused: the
    eroded image stays in shared memory)."""
    T, H, W = img.shape
    out = torch.empty_like(img)
    runs = _runs_table(int(ksize))
    _call(img.device, load_library().lt_tophat,
          img.data_ptr(), out.data_ptr(), None, runs.ctypes.data, len(runs),
          int(ksize), T, H, W)
    return out


def _prefix_buffer(like: torch.Tensor) -> torch.Tensor:
    """The (T, H, W + 1) int32 packed prefixes of a (T, H, W) batch."""
    T, H, W = like.shape
    return torch.empty((T, H, W + 1), dtype=torch.int32, device=like.device)


def _launch_open_prefix(merged: torch.Tensor, open_k: int) -> tuple:
    """The open + prefix tail alone, one launch: (binary, packed
    prefixes) of a merged 0/255 image."""
    T, H, W = merged.shape
    out, pref = torch.empty_like(merged), _prefix_buffer(merged)
    runs = _runs_table(int(open_k))
    _call(merged.device, load_library().lt_open_prefix,
          merged.data_ptr(), out.data_ptr(), pref.data_ptr(), runs.ctypes.data,
          len(runs), int(open_k), T, H, W, _count_shift(W))
    return out, pref


def _launch_thr_merge_open(r_th, b_feat, keep, kb, Cb, open_k) -> tuple:
    """The threshold into a scratch image, then the tail with the merge in
    its load: two launches."""
    T, H, W = r_th.shape
    out, pref = torch.empty_like(r_th), _prefix_buffer(r_th)
    b_th = torch.empty_like(r_th)
    runs = _runs_table(int(open_k))
    _call(r_th.device, load_library().lt_thr_merge_open,
          r_th.data_ptr(), b_feat.data_ptr(),
          None if keep is None else keep.data_ptr(), out.data_ptr(),
          pref.data_ptr(), b_th.data_ptr(), runs.ctypes.data, len(runs),
          int(open_k), T, H, W, int(kb), int(Cb), _count_shift(W))
    return out, pref


def _launch_merge_open(r_th, b_th, keep, open_k) -> tuple:
    """The tail with the merge in its load: one launch."""
    T, H, W = r_th.shape
    out, pref = torch.empty_like(r_th), _prefix_buffer(r_th)
    runs = _runs_table(int(open_k))
    _call(r_th.device, load_library().lt_merge_open,
          r_th.data_ptr(), b_th.data_ptr(),
          None if keep is None else keep.data_ptr(), out.data_ptr(),
          pref.data_ptr(), runs.ctypes.data, len(runs), int(open_k), T, H, W,
          _count_shift(W))
    return out, pref


def _launch_adaptive_mean(img: torch.Tensor, k: int, C: int) -> torch.Tensor:
    T, H, W = img.shape
    out = torch.empty_like(img)
    _call(img.device, load_library().lt_adaptive_mean,
          img.data_ptr(), out.data_ptr(), T, H, W, int(k), int(C))
    return out


def _launch_threshold(img: torch.Tensor, k: int, C: int,
                      noise_thresh: int) -> torch.Tensor:
    T, H, W = img.shape
    out = torch.empty_like(img)
    _call(img.device, load_library().lt_cross_threshold,
          img.data_ptr(), out.data_ptr(), T, H, W, int(k), int(C),
          int(noise_thresh))
    return out


# ---- tophat_ellipse ------------------------------------------------------


def tophat_ellipse_plain(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Plain twin of ``tophat_ellipse``."""
    return _tophat_plain(img, ksize)


def tophat_ellipse(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """White tophat img - open(img) with OpenCV's ksize x ksize ellipse;
    the kernel takes ksize odd, at most TOPHAT_MAX_K (the twin any)."""
    if not _on_cuda(img):
        return tophat_ellipse_plain(img, ksize)
    out = _launch_tophat(img, _tophat_k(ksize))
    LAUNCHES["tophat_ellipse"] += 1
    return out


# ---- tophat_staged -------------------------------------------------------


def tophat_staged_plain(img: torch.Tensor, ksize: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """Plain twin of ``tophat_staged`` (the staging type does not change
    the function)."""
    if dtype not in STAGING:
        raise ValueError(f"no staging type {dtype}; one of {list(STAGING)}")
    return _tophat_plain(img, ksize)


def _launch_staged(img: torch.Tensor, ksize: int, code: int) -> torch.Tensor:
    """One launch of the staged tophat (lt_tophat_staged's ``stage``
    code; its scratch argument unused)."""
    T, H, W = img.shape
    out = torch.empty_like(img)
    runs = _runs_table(int(ksize))
    _call(img.device, load_library().lt_tophat_staged,
          img.data_ptr(), out.data_ptr(), None, runs.ctypes.data, len(runs),
          int(ksize), T, H, W, int(code))
    return out


def tophat_staged(img: torch.Tensor, ksize: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``tophat_ellipse`` with the kernel's shared planes in ``dtype``
    (bfloat16 or float32) instead of uint8; ksize as ``tophat_ellipse``'s
    on the card."""
    if dtype not in STAGING:
        raise ValueError(f"no staging type {dtype}; one of {list(STAGING)}")
    if not _on_cuda(img):
        return tophat_staged_plain(img, ksize, dtype)
    out = _launch_staged(img, _tophat_k(ksize), STAGING[dtype])
    LAUNCHES["tophat_staged"] += 1
    return out


def tophat_plan(ksize: int, H: int, W: int, elem: int = 1) -> dict:
    """The tile the tophat kernels plan for an H x W frame with their
    planes at ``elem`` bytes a pixel (1: ``tophat_ellipse`` and
    ``dual_tophat``; 2 and 4: ``tophat_staged``'s bf16 and f32), from the
    library: {tw, th, tq, rq, shape (0: two CTAs an SM, 1: one), smem}."""
    runs = _runs_table(_tophat_k(ksize))
    out = np.zeros(6, np.int32)
    _check(load_library().lt_tophat_plan(
        runs.ctypes.data, len(runs), int(ksize), int(elem), int(H), int(W),
        out.ctypes.data), "lt_tophat_plan")
    return dict(zip(("tw", "th", "tq", "rq", "shape", "smem"),
                    map(int, out)))


# ---- dual_tophat ---------------------------------------------------------


def dual_tophat_plain(a: torch.Tensor, b: torch.Tensor, ka: int, kb: int):
    """Plain twin of ``dual_tophat``."""
    return _tophat_plain(a, ka), _tophat_plain(b, kb)


def dual_tophat(a: torch.Tensor, b: torch.Tensor, ka: int, kb: int):
    """``(tophat_ellipse(a, ka), tophat_ellipse(b, kb))`` for two (T, H, W)
    uint8 batches of one shape, both in one launch; ka and kb as
    ``tophat_ellipse``'s ksize on the card."""
    if not _on_cuda(a, b):
        return dual_tophat_plain(a, b, ka, kb)
    ka, kb = _tophat_k(ka), _tophat_k(kb)
    T, H, W = a.shape
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    runs_a, runs_b = _runs_table(ka), _runs_table(kb)
    _call(a.device, load_library().lt_dual_tophat,
          a.data_ptr(), b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
          None, None, runs_a.ctypes.data, len(runs_a), ka, runs_b.ctypes.data,
          len(runs_b), kb, T, H, W)
    LAUNCHES["dual_tophat"] += 1
    return out_a, out_b


# ---- tophat_riders -------------------------------------------------------


def tophat_riders_plain(img, ksize, riders):
    """Plain twin of ``tophat_riders``."""
    return (_tophat_plain(img, ksize),
            *(cross_threshold(src, k, C, nt) for src, k, C, nt in riders))


def tophat_riders(img: torch.Tensor, ksize: int, riders) -> tuple:
    """``(tophat(img), thr(src_0), ..., thr(src_n-1))`` for riders
    ``(src, k, C, noise_thresh)``: each a bilateral cross threshold of its
    own input (noise_thresh = -1), or with ``noise_thresh >= 0`` the noise
    keep-mask ``(src < noise_thresh) | thr(src)``.  ksize as
    ``tophat_ellipse``'s, each rider's k at most THRESHOLD_MAX_K on the
    card; all are checked before the first launch."""
    if not _on_cuda(img, *(r[0] for r in riders)):
        return tophat_riders_plain(img, ksize, riders)
    ksize = _tophat_k(ksize)
    riders = [(src, _threshold_k(k), C, nt) for src, k, C, nt in riders]
    outs = (_launch_tophat(img, ksize),
            *(_launch_threshold(src, k, C, nt) for src, k, C, nt in riders))
    LAUNCHES["tophat_riders"] += 1
    return outs


# ---- thr_merge_open ------------------------------------------------------


def thr_merge_open_plain(r_th, b_feat, kb, Cb, keep=None, open_k=5):
    """Plain twin of ``thr_merge_open``."""
    return merge_open_plain(r_th, cross_threshold(b_feat, kb, Cb), keep,
                            open_k)


def thr_merge_open(r_th: torch.Tensor, b_feat: torch.Tensor, kb: int,
                   Cb: int, keep: torch.Tensor | None = None,
                   open_k: int = 5):
    """open_k ellipse opening of ``((r_th | thr(b_feat, kb, Cb)) & keep)``
    as 0/255, plus its packed exclusive row prefixes (T, H, W + 1) int32
    with ``shift = (W + 1).bit_length()``.  Returns (binary, RowPrefixes).
    kb at most THRESHOLD_MAX_K and open_k odd, at most OPEN_MAX_K, on the
    card (the twin takes any)."""
    imgs = (r_th, b_feat) if keep is None else (r_th, b_feat, keep)
    if not _on_cuda(*imgs):
        return thr_merge_open_plain(r_th, b_feat, kb, Cb, keep, open_k)
    kb, open_k = _threshold_k(kb), _open_k(open_k)
    out, pref = _launch_thr_merge_open(r_th, b_feat, keep, kb, Cb, open_k)
    LAUNCHES["thr_merge_open"] += 1
    return out, RowPrefixes(packed=pref)


# ---- adaptive_mean -------------------------------------------------------


def adaptive_mean_plain(img: torch.Tensor, ksize: int, C: int) -> torch.Tensor:
    """Plain twin of ``adaptive_mean``."""
    return adaptive_mean_threshold(img, ksize, C)


def adaptive_mean(img: torch.Tensor, ksize: int, C: int) -> torch.Tensor:
    """``cv2.adaptiveThreshold(img, 255, MEAN_C, BINARY, ksize, C)``: 255
    where ``img - round(box mean) > -C``, replicate border; ksize odd, at
    most ADAPTIVE_MEAN_MAX_K on the card (the twin takes any odd k, as
    JAX's kernel does)."""
    k = int(ksize)
    if k % 2 != 1 or k < 1:
        raise ValueError(f"adaptive mean threshold needs an odd ksize >= 1, "
                         f"got {ksize}")
    if not _on_cuda(img):
        return adaptive_mean_plain(img, k, C)
    if k > ADAPTIVE_MEAN_MAX_K:
        raise ValueError(f"the adaptive-mean kernel needs an odd ksize in "
                         f"[1, {ADAPTIVE_MEAN_MAX_K}], got {ksize}")
    out = _launch_adaptive_mean(img, k, C)
    LAUNCHES["adaptive_mean"] += 1
    return out


# ---- merge_open ----------------------------------------------------------


def merge_open_plain(r_th, b_th, keep=None, open_k=5):
    """Plain twin of ``merge_open``."""
    merged = (r_th > 0) | (b_th > 0)
    if keep is not None:
        merged = merged & (keep > 0)
    binary = open_ellipse(torch.where(merged, 255, 0).to(torch.uint8), open_k)
    return binary, build_row_prefixes(binary)


def merge_open(r_th: torch.Tensor, b_th: torch.Tensor,
               keep: torch.Tensor | None = None, open_k: int = 5):
    """open_k ellipse opening of ``((r_th | b_th) & keep)`` as 0/255, plus
    its packed exclusive row prefixes (T, H, W + 1) int32.  Returns
    (binary, RowPrefixes).  open_k odd, at most OPEN_MAX_K, on the card
    (the twin takes any)."""
    imgs = (r_th, b_th) if keep is None else (r_th, b_th, keep)
    if not _on_cuda(*imgs):
        return merge_open_plain(r_th, b_th, keep, open_k)
    out, pref = _launch_merge_open(r_th, b_th, keep, _open_k(open_k))
    LAUNCHES["merge_open"] += 1
    return out, RowPrefixes(packed=pref)


# ---- bilateral_threshold -------------------------------------------------


def bilateral_threshold_plain(img, ksize, C, noise_thresh=-1):
    """Plain twin of ``bilateral_threshold``."""
    return cross_threshold(img, ksize, C, noise_thresh)


def bilateral_threshold(img: torch.Tensor, ksize: int, C: int,
                        noise_thresh: int = -1) -> torch.Tensor:
    """Bilateral cross threshold (mode 'floor') of img, or with
    ``noise_thresh >= 0`` the noise keep-mask ``(img < noise_thresh) |
    thr(img)``, as 0/255; ksize at most THRESHOLD_MAX_K on the card."""
    if not _on_cuda(img):
        return bilateral_threshold_plain(img, ksize, C, noise_thresh)
    out = _launch_threshold(img, _threshold_k(ksize), C, noise_thresh)
    LAUNCHES["bilateral_threshold"] += 1
    return out
