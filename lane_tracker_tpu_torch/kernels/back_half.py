"""The back half's scan as one hand-written CUDA kernel: the wrapper.

``scan(states, arts, params, config)`` runs the back half of S streams
over their T frames (search intervals, interval moments, the fit,
validity, the hoisted second attempt, the state update) in one launch of
``back_half_scan_kernel`` (csrc/back_half.cu: one thread block a stream,
the tracker state in shared memory from frame to frame), and adds one to
``LAUNCHES["back_half"]`` and S x T to the ``lt.back_half.kernel_frames``
counter.  The kernel replaces no Pallas kernel: the JAX package's back
half is a ``lax.scan`` (lane_tracker_tpu/parallel/pipeline.py:42-50).

Its plain twins are the per-frame loops it takes the place of,
``parallel.pipeline.scan_back_half_plain`` (one stream) and
``parallel.streams.scan_streams_plain`` (S streams, ``vmap``ped).
``scan_back_half`` and ``scan_streams`` take the kernel where
``takes_kernel`` holds: the artifacts lie on a CUDA device and the scan
needs no host decision (attempt-2 artifacts are present, or the config
has one attempt).  On the CPU the twins run; 'cond' with a second attempt
reads attempt 1's validity on the host every frame, so it keeps the
per-frame loop as a schedule of its own.  On CUDA a scan that qualifies
launches the kernel or raises: nothing falls back.

The kernel's layout of a state (``pack_state``): each ``TrackerState``
field, in order, as a contiguous tensor with a leading stream axis in the
field's own type (a bool read as uint8); ``unpack_state`` is its inverse.
The kernel reads S states and writes S new ones, and writes every field of
the ``StepOutput`` stack (the overlay aside) and of the ``RenderMeta``
stack into (S, T, ...) tensors the wrapper allocates.
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.kernels.filter_stage import _call, _one_device
from lane_tracker_tpu_torch.ops import f32
from lane_tracker_tpu_torch.ops.polyfit import ploty_grid
from lane_tracker_tpu_torch.tracker.config import TrackerConfig
from lane_tracker_tpu_torch.tracker.state import TrackerState
from lane_tracker_tpu_torch.tracker.step import (
    FrontArtifacts,
    RenderMeta,
    StepOutput,
    TrackerParams,
    _sa_config,
    has_second_attempt,
)
from lane_tracker_tpu_torch.utils.profiling import count

SOURCE = {"back_half": "lane_tracker_tpu_torch/csrc/back_half.cu"}
REPLACES = {"back_half": "no Pallas kernel: the lax.scan of back_half, "
                         "lane_tracker_tpu/parallel/pipeline.py:42"}
LAUNCHES = {name: 0 for name in REPLACES}
# The tallest warped image and the longest history the kernel takes
# (its shared memory holds 40 bytes a row; csrc/back_half.cu kMaxAvg).
MAX_ROWS = 4096
MAX_AVERAGE = 32

_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool
# Each TrackerState field's type and shape after the stream axis ("N" the
# history's length, "H" the warped height).
STATE_LAYOUT = {
    "last_detection": (_I32, ()), "hist_left": (_F32, ("N", 3)),
    "hist_right": (_F32, ("N", 3)), "hist_valid": (_BOOL, ("N",)),
    "last_left": (_F32, (3,)), "last_right": (_F32, (3,)),
    "avg_left": (_F32, (3,)), "avg_right": (_F32, (3,)),
    "has_avg": (_BOOL, ()), "rfitx_left": (_F32, ("H",)),
    "rfitx_right": (_F32, ("H",)), "rn_left": (_I32, ()),
    "rn_right": (_I32, ()), "rfirst_left": (_I32, ()),
    "rfirst_right": (_I32, ()), "radii": (_F32, ("N",)),
    "avg_radius": (_F32, ()), "ecc": (_F32, ()), "counter": (_I32, ()),
    "success": (_I32, ()),
}
# The StepOutput fields the kernel writes (all but the overlay) and the
# RenderMeta fields, each (S, T) + the shape given.
OUT_LAYOUT = {
    "render_mode": (_I32, ()), "valid": (_BOOL, ()),
    "detected": (_BOOL, ()), "search_mode": (_I32, ()),
    "n_attempts": (_I32, ()), "radius": (_F32, ()), "ecc": (_F32, ()),
    "left_coeffs": (_F32, (3,)), "right_coeffs": (_F32, (3,)),
    "n_points_left": (_I32, ()), "n_points_right": (_I32, ()),
    "a1_detected": (_BOOL, ()), "a1_valid": (_BOOL, ()),
    "a1_left_coeffs": (_F32, (3,)), "a1_right_coeffs": (_F32, (3,)),
    "a1_n_left": (_I32, ()), "a1_n_right": (_I32, ()),
    "corridor_ok": (_BOOL, ()),
}
META_LAYOUT = {
    "fitx_left": (_F32, ("H",)), "fitx_right": (_F32, ("H",)),
    "coeffs_left": (_F32, (3,)), "coeffs_right": (_F32, (3,)),
    "n_left": (_I32, ()), "n_right": (_I32, ()), "first_left": (_I32, ()),
    "first_right": (_I32, ()), "draw": (_BOOL, ()),
}
# The blind intervals' fields the kernel reads, in the pointer table's
# order: per row, then per level.
ROW_FIELDS = ("left_lo", "left_hi", "left_valid", "right_lo", "right_hi",
              "right_valid")
LEVEL_FIELDS = ("left_read_lo", "left_read_hi", "right_read_lo",
                "right_read_hi")


def kernel_eligible(arts: FrontArtifacts, config: TrackerConfig) -> bool:
    """The scan needs no host decision inside it: the hoisted attempt-2
    artifacts are present, or the config has one attempt."""
    return arts.pref2 is not None or not has_second_attempt(config)


def takes_kernel(arts: FrontArtifacts, config: TrackerConfig) -> bool:
    """``scan_back_half`` and ``scan_streams`` launch the kernel: the
    artifacts lie on a CUDA device and ``kernel_eligible`` holds."""
    return (arts.pref.packed.device.type == "cuda"
            and kernel_eligible(arts, config))


def _sizes(shape, N: int, H: int) -> tuple:
    return tuple({"N": N, "H": H}.get(d, d) for d in shape)


def pack_state(state: TrackerState) -> list:
    """The kernel's layout of ``state`` (S streams, a leading (S,) axis):
    its fields in order, each a contiguous tensor, bools read as uint8.
    Views, no copy, where the fields are contiguous; a mistyped or
    misshapen field raises ValueError."""
    N, H = state.hist_valid.shape[-1], state.rfitx_left.shape[-1]
    S = state.last_detection.shape[0]
    out = []
    for name, x in zip(TrackerState._fields, state):
        dtype, shape = STATE_LAYOUT[name]
        want = (S,) + _sizes(shape, N, H)
        if x.dtype != dtype or tuple(x.shape) != want:
            raise ValueError(f"state field {name}: {x.dtype} "
                             f"{tuple(x.shape)}, the kernel takes {dtype} "
                             f"{want}")
        out.append(x.view(torch.uint8) if dtype == _BOOL else x)
    return out


def unpack_state(fields: list) -> TrackerState:
    """The TrackerState of ``pack_state``'s layout."""
    return TrackerState(*(x.view(torch.bool) if dtype == _BOOL else x
                          for (dtype, _), x in zip(STATE_LAYOUT.values(),
                                                   fields)))


def _check(name: str, x: torch.Tensor, dtype, shape) -> torch.Tensor:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)}, the kernel "
                         f"takes {dtype} {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return x


def _attempt(pref, iv, S: int, T: int, H: int, W: int, tag: str) -> list:
    """One attempt's pointer-table tensors: the packed prefixes, the
    blind intervals' row fields, then their level fields; checked."""
    out = [_check(f"{tag} prefixes", pref.packed, _I32, (S, T, H, W + 1))]
    for name in ROW_FIELDS:
        dtype = _BOOL if name.endswith("valid") else _I32
        out.append(_check(f"{tag} {name}", getattr(iv, name), dtype,
                          (S, T, H)))
    L = iv.left_read_lo.shape[-1]
    for name in LEVEL_FIELDS:
        out.append(_check(f"{tag} {name}", getattr(iv, name), _I32,
                          (S, T, L)))
    return out


def _check_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no back-half kernel for device {device}")


def _launch(device: torch.device, ptrs: np.ndarray, ints: np.ndarray,
            floats: np.ndarray) -> None:
    """One launch of the kernel with its three host tables (their order:
    csrc/back_half.cu's enums), on ``device``'s current stream."""
    _call(device, load_library().lt_back_half, ptrs.ctypes.data, len(ptrs),
          ints.ctypes.data, len(ints), floats.ctypes.data, len(floats))


def scan(states: TrackerState, arts: FrontArtifacts, params: TrackerParams,
         config: TrackerConfig):
    """The back half of S streams over their T frames in one kernel
    launch.  ``states``: S states with a leading (S,) axis; ``arts``:
    their (S, T, ...) artifacts.  Returns (states, (StepOutput without the overlay, RenderMeta))
    with leading (S, T) axes, as the twins.  Raises ValueError, before any
    launch, for inputs the kernel does not take: another type, shape or
    device, a non-contiguous tensor, artifacts off the card, a scan that
    needs a host decision."""
    fields = pack_state(states)
    S, T, H, Wp1 = arts.pref.packed.shape
    W = params.warped_size[0]
    if (H, W + 1) != (params.warped_size[1], Wp1):
        raise ValueError(f"prefixes of {H} rows of {Wp1} for a warped size "
                         f"of {params.warped_size}")
    N = fields[TrackerState._fields.index("hist_valid")].shape[-1]
    for name, x in zip(TrackerState._fields, fields):
        _check(f"state field {name}", x, x.dtype, (S,) + x.shape[1:])
    two = has_second_attempt(config)
    tensors = _attempt(arts.pref, arts.iv_sws, S, T, H, W, "attempt 1")
    if two:
        if arts.pref2 is None:
            raise ValueError("a scan with a second attempt needs its hoisted "
                             "artifacts (the 'cond' schedule reads attempt 1 "
                             "on the host: no kernel)")
        tensors += _attempt(arts.pref2, arts.iv_sws2, S, T, H, W,
                            "attempt 2")
    device = _one_device(*tensors, *fields)
    _check_device(device)
    if not (1 <= T and H <= MAX_ROWS and 1 <= N <= MAX_AVERAGE):
        raise ValueError(f"the kernel takes 1 or more frames, at most "
                         f"{MAX_ROWS} rows and a history of 1 to "
                         f"{MAX_AVERAGE}, got T={T}, H={H}, n_average={N}")
    ploty_v = ploty_grid(params.warped_size, 1.0, device)
    ploty_r = ploty_grid(params.warped_size, config.search.partial, device)

    def alloc(layout, lead):
        return {name: torch.empty(lead + _sizes(shape, N, H), dtype=dtype,
                                  device=device)
                for name, (dtype, shape) in layout.items()}

    st_out = alloc(STATE_LAYOUT, (S,))
    outs = alloc(OUT_LAYOUT, (S, T))
    metas = alloc(META_LAYOUT, (S, T))
    n_attempt_ptrs = 1 + len(ROW_FIELDS) + len(LEVEL_FIELDS)
    ptrs = [x.data_ptr() for x in tensors]
    ptrs += [0] * (2 * n_attempt_ptrs - len(ptrs))
    ptrs += [ploty_v.data_ptr(), ploty_r.data_ptr()]
    ptrs += [x.data_ptr() for x in fields]
    ptrs += [x.data_ptr() for x in st_out.values()]
    ptrs += [x.data_ptr() for x in outs.values()]
    ptrs += [x.data_ptr() for x in metas.values()]
    # The int and float tables in csrc/back_half.cu's IntParam and
    # FloatParam order; the floats are rounded to float32 once, as f32().
    searches = (config.search, _sa_config(params).search)
    v = config.validity
    col_roi = params.col_roi
    ints = [S, T, H, W, (W + 1).bit_length(), N, ploty_r.shape[0],
            config.n_reset, config.n_fail, 2 if two else 1,
            W if v.y_eval_from_width else H, col_roi is not None,
            *(col_roi or (0, 0)), arts.iv_sws.left_read_lo.shape[-1],
            0 if not two else arts.iv_sws2.left_read_lo.shape[-1],
            *(int(H * (1 - sc.partial)) for sc in searches),
            *(H - int(sc.ignore_bottom) for sc in searches)]
    floats = [*(f32(sc.bandwidth) for sc in searches), v.min_dist_y1,
              v.max_dist_y1, v.min_dist_y2, v.max_dist_y2, v.min_dist_y3,
              v.max_dist_y3, v.tangent_thresh, 0.35, 0.75, params.mppv,
              params.mpph, params.mppv * params.mppv]
    _launch(device, np.asarray(ptrs, dtype=np.int64),
            np.asarray(ints, dtype=np.int32),
            np.asarray(floats, dtype=np.float32))
    LAUNCHES["back_half"] += 1
    count("lt.back_half.kernel_frames", S * T)
    return unpack_state(list(st_out.values())), (
        StepOutput(None, *outs.values()), RenderMeta(*metas.values()))


def kernel_launches() -> int:
    """Launches of the back-half kernel the library has made so far (its
    own counter, ``lt_back_half_launches``; the filter stage's counter
    does not count them)."""
    return int(load_library().lt_back_half_launches())
