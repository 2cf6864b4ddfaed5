"""Warp + LAB-B as hand-written CUDA: the wrapper.

``warp_lab(raw, g_und, g_warp, out=None)`` takes T frames' raw rows,
uint8 (T, rows, Wc, 3), through a fixed-point undistort grid and a float
warp grid to the warped R and LAB-B planes, uint8 (T, H, W) each (new, or
the caller's ``out``), in one call of ``lt_warp_lab`` (csrc/warp_lab.cu:
the undistort into a uint8 band, then the float warp and LAB-B straight to
the planes; two kernel launches), and adds one to ``LAUNCHES["warp_lab"]``
and T to the ``lt.warp_lab.kernel_frames`` counter.  The kernels replace no Pallas
kernel: the JAX package leaves the stage to XLA.  They read the grids'
buffers as ``ResampleGrid`` holds them (int64 bases; int32 2^15 weights,
float64 weights holding float32 values), so nothing is converted or
copied for them.

Its plain twin is the PyTorch chain it takes the place of,
``tracker.step.warp_rows_plain`` (kernels/resample.py's gathers and
ops/color.py's LAB-B), bit for bit.  ``tracker.step.warp_rows`` takes the
kernels where ``takes_kernel`` holds: the raw rows lie on a CUDA device
and the chain ``qualifies`` (not 'turbo''s order, no row-matmul tiles, a
fixed-point undistort grid and a float warp grid).  That covers 'fast',
'corridor', 'half' and 'compat' (``rgb2lab_b_u8`` and ``rgb2lab_b_fast``
are one function given ``gamma_tab``); on the CPU the twin runs.  On CUDA
a chain that qualifies launches the kernels or raises: nothing falls back.
"""

from __future__ import annotations

import torch

from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.kernels.filter_stage import _call, _one_device
from lane_tracker_tpu_torch.kernels.resample import ResampleGrid
from lane_tracker_tpu_torch.ops.color import (
    _cbrt_table,
    _gamma_table,
    _tables,
)
from lane_tracker_tpu_torch.utils.profiling import count

SOURCE = {"warp_lab": "lane_tracker_tpu_torch/csrc/warp_lab.cu"}
REPLACES = {"warp_lab": "no Pallas kernel: the XLA gather chain of "
                        "lane_tracker_tpu/tracker/step.py _warp_channels, "
                        "kernels/resample.py, ops/color.py"}
LAUNCHES = {name: 0 for name in REPLACES}
_SLOTS = ("base", "w00", "w01", "w10", "w11")


def qualifies(chain) -> bool:
    """The kernels compute ``chain`` (a ``tracker.step.WarpChain``): not
    'turbo''s order, no row-matmul tiles, a fixed-point undistort grid and
    a float warp grid."""
    return (not chain.turbo and chain.mm_und is None
            and chain.mm_warp is None and not chain.g_und.is_float
            and chain.g_warp.is_float)


def takes_kernel(raw: torch.Tensor, chain) -> bool:
    """``tracker.step.warp_rows`` launches the kernels: the raw rows lie on
    a CUDA device and the chain ``qualifies``."""
    return raw.device.type == "cuda" and qualifies(chain)


def _grid_buffers(name: str, g: ResampleGrid, wdtype) -> list:
    """The base and the four weight planes of ``g``, checked to be the
    contiguous int64 and ``wdtype`` buffers of its destination pixels."""
    n = g.dst_shape[0] * g.dst_shape[1]
    out = [getattr(g, k) for k in _SLOTS]
    for k, x in zip(_SLOTS, out):
        dtype = torch.int64 if k == "base" else wdtype
        if x.dtype != dtype or x.shape != (n,) or not x.is_contiguous():
            raise ValueError(f"{name} grid {k}: {x.dtype} "
                             f"{tuple(x.shape)}, the kernel takes "
                             f"contiguous {dtype} ({n},)")
    return out


def _check_raw(raw: torch.Tensor, g_und: ResampleGrid) -> None:
    width, rows = g_und.src_size
    if raw.dtype != torch.uint8 or raw.dim() != 4 or (
            tuple(raw.shape[1:]) != (rows, width, 3)) or raw.shape[0] < 1:
        raise ValueError(f"raw rows: {raw.dtype} {tuple(raw.shape)}, the "
                         f"kernel takes uint8 (T, {rows}, {width}, 3)")
    if raw.stride()[1:] != (3 * width, 3, 1):
        raise ValueError("raw rows: the kernel takes each frame's rows "
                         f"contiguous, got strides {raw.stride()}")
    if raw.stride(0) >= 2 ** 31:
        raise ValueError(f"raw rows: a frame stride of {raw.stride(0)} "
                         "bytes, the kernel takes less than 2^31")


def _check_planes(out, shape) -> None:
    if len(out) != 2:
        raise ValueError(f"{len(out)} planes, the kernel writes R and LAB-B")
    for name, x in zip(("R", "LAB-B"), out):
        if x.dtype != torch.uint8 or tuple(x.shape) != shape or (
                not x.is_contiguous()):
            raise ValueError(f"{name} plane: {x.dtype} {tuple(x.shape)}, the "
                             f"kernel writes contiguous uint8 {shape}")


def warp_lab(raw: torch.Tensor, g_und: ResampleGrid, g_warp: ResampleGrid,
             out=None) -> tuple:
    """Warped R and LAB-B, uint8 (T, H, W) each, of (T, rows, Wc, 3) uint8
    raw rows (each frame's rows contiguous; frames any stride apart)
    through the fixed-point undistort grid ``g_und`` and the float warp
    grid ``g_warp``, in one call of the kernels; written into ``out``, two
    contiguous uint8 (T, H, W) planes, where given, else into new ones.
    Raises ValueError, before any launch, for inputs they do not take:
    another type or shape, rows or planes not contiguous, grids of another
    kind or not chained, tensors on several devices or off the card."""
    _check_raw(raw, g_und)
    rows, width = g_und.dst_shape
    if g_warp.src_size != (width, rows):
        raise ValueError(f"warp grid source {g_warp.src_size} is not the "
                         f"undistorted image {(width, rows)}")
    T = raw.shape[0]
    H, W = g_warp.dst_shape
    if out is not None:
        _check_planes(out, (T, H, W))
    und = _grid_buffers("undistort", g_und, torch.int32)
    warp = _grid_buffers("warp", g_warp, torch.float64)
    device = _one_device(raw, *und, *warp, *(out or ()))
    if device.type != "cuda":
        raise ValueError(f"no warp + LAB kernel for device {device}")
    band = torch.empty((T, rows, width, 3), dtype=torch.uint8, device=device)
    if out is None:
        out = tuple(torch.empty((T, H, W), dtype=torch.uint8, device=device)
                    for _ in range(2))
    r_out, b_out = out
    coeffs = _tables()[2]
    _call(device, load_library().lt_warp_lab, raw.data_ptr(), raw.stride(0),
          g_und.src_size[0], *(x.data_ptr() for x in und), rows * width,
          width, band.data_ptr(), *(x.data_ptr() for x in warp), H * W,
          _gamma_table(device).data_ptr(), _cbrt_table(device).data_ptr(),
          *(int(v) for v in coeffs[1]), *(int(v) for v in coeffs[2]),
          r_out.data_ptr(), b_out.data_ptr(), T)
    LAUNCHES["warp_lab"] += 1
    count("lt.warp_lab.kernel_frames", T)
    return r_out, b_out


def kernel_launches() -> int:
    """Kernel launches of ``lt_warp_lab`` the library has made so far (its
    own counter, ``lt_warp_lab_launches``: two a call)."""
    return int(load_library().lt_warp_lab_launches())
