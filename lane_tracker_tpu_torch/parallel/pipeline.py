"""Chunked pipeline: batched front half, sequential back half, overlays.

Port of lane_tracker_tpu/parallel/pipeline.py:42-134.  A chunk of T frames
runs the stateless front half (warp, LAB, the three filter kernels,
sliding-window precompute) once on the whole batch, then the back half
over the frames in order, carrying the tracker state (``scan_back_half``:
on the card one launch of the back-half kernel, kernels/back_half.py,
where no frame needs a host decision; else the per-frame loop), then the
overlays for all T frames at once.

``second_attempt`` schedules the fallback attempt's 'neighborhood' filter
(two adaptive-mean kernels and one merge-open kernel) as the reference
does; all three modes give identical outputs:

* 'cond' (the default): per frame, one host read of attempt 1's validity;
  only a failing frame runs the filter, on its own channels.
* 'hoist': the front half runs the filter for every frame, and each frame
  selects between its two attempts.
* 'two_phase': an attempt-1-only scan; only if some frame failed, the
  filter runs once on the whole chunk and the chunk is rescanned from the
  original state with both attempts.

``build_chunk_processor`` is the processor cached per static config, as
the reference's jit-compiled one, that ``LaneTracker.process_chunk`` and
the CLI call.

Each stage runs inside a ``utils.profiling.span`` named ``lt.<stage>``
(warp_lab, filter, embed_search, second_attempt, back_half, overlay) under
the chunk's root span ``lt.chunk``; two_phase's ranges are siblings, one
``lt.back_half`` per scan, and the per-frame loop's parts are its
``lt.back_half.*`` spans (the kernel's launch opens none).
benchmark/trace.py reads the ranges from a profile and
benchmark/program.py the spans and counters from a recording; PERF.md §3
lists them all.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from lane_tracker_tpu_torch.kernels import back_half as back_half_kernel
from lane_tracker_tpu_torch.parallel.mesh import map_tensors
from lane_tracker_tpu_torch.tracker.config import TrackerConfig
from lane_tracker_tpu_torch.tracker.state import TrackerState
from lane_tracker_tpu_torch.tracker.step import (
    FrontArtifacts,
    TrackerParams,
    back_half,
    frame_artifacts,
    front_artifacts_batch,
    has_second_attempt,
    render_frame,
    second_attempt_artifacts_batch,
)
from lane_tracker_tpu_torch.tracker.upload import StreamedChunk
from lane_tracker_tpu_torch.utils.profiling import (
    count,
    host_read,
    span,
    unit,
)

MODES = ("cond", "hoist", "two_phase")


def _stack(items: list, dim: int = 0):
    """Stack a list of same-type NamedTuples field by field."""
    cls = type(items[0])
    return cls(*(None if fs[0] is None else torch.stack(fs, dim)
                 for fs in zip(*items)))


def scan_back_half(state: TrackerState, arts: FrontArtifacts,
                   params: TrackerParams, config: TrackerConfig):
    """The back half over the chunk's frames in order.  Returns
    (state, (StepOutput stack, RenderMeta stack)) with a leading T axis.

    On the card, where no frame needs a host decision (``kernels.
    back_half.takes_kernel``), one launch of the back-half kernel scans
    the chunk; else the plain twin, ``scan_back_half_plain``."""
    T = arts.pref.packed.shape[0]
    count("lt.back_half.frames", T)
    if back_half_kernel.takes_kernel(arts, config):
        # The kernel scans S streams: this one as S = 1, by views.
        states, (out, meta) = back_half_kernel.scan(
            map_tensors(lambda x: x[None], state),
            map_tensors(lambda x: x[None], arts), params, config)
        first = functools.partial(map_tensors, lambda x: x[0])
        return first(states), (first(out), first(meta))
    return scan_back_half_plain(state, arts, params, config)


def scan_back_half_plain(state: TrackerState, arts: FrontArtifacts,
                         params: TrackerParams, config: TrackerConfig):
    """The plain twin of the back-half kernel: ``back_half`` one frame at
    a time (the 'cond' schedule's per-frame host read included)."""
    T = arts.pref.packed.shape[0]
    outs, metas = [], []
    for t in range(T):
        state, out, meta = back_half(state, frame_artifacts(arts, t), params,
                                     config)
        outs.append(out)
        metas.append(meta)
    with span("lt.back_half.stack"):
        return state, (_stack(outs), _stack(metas))


def two_phase_scan(state: TrackerState, arts: FrontArtifacts,
                   params: TrackerParams, config: TrackerConfig):
    """The reference's two_phase schedule.  Phase 1 scans attempt 1 only;
    one host check per chunk decides whether phase 2 runs: the batched
    second-attempt front on the chunk's channels, then a rescan from the
    ORIGINAL state with the full config and the hoisted artifacts."""
    cfg1 = dataclasses.replace(config, n_tries=1)
    with span("lt.back_half"):
        st1, (outs1, metas1) = scan_back_half(state, arts, params, cfg1)
        all_valid = bool(host_read(outs1.valid.all()))
    if all_valid:
        return st1, (outs1, metas1)
    count("lt.rescans")
    with span("lt.second_attempt"):
        pref2, iv2 = second_attempt_artifacts_batch(arts.r_chan, arts.b_chan,
                                                    params)
    with span("lt.back_half"):
        return scan_back_half(state, arts._replace(pref2=pref2, iv_sws2=iv2),
                              params, config)


def chunk_process(state: TrackerState, frames: torch.Tensor | StreamedChunk,
                  params: TrackerParams, config: TrackerConfig,
                  with_overlay: bool = True,
                  second_attempt: str | None = None):
    """Process a (T, Hc, Wc, 3) uint8 chunk on ``frames.device``.
    ``frames`` may also be a ``tracker.upload.StreamedChunk`` of host
    frames (``LaneTracker.process_chunk``'s): its warp runs a slice at a
    time as each slice lands on the device.

    ``second_attempt`` is 'cond', 'hoist' or 'two_phase' (module
    docstring); None means 'cond'.  'cond' reads attempt 1's validity on
    the host once per frame, so it keeps the per-frame loop; 'hoist' and
    'two_phase' never wait on the device inside a scan (two_phase waits
    once per chunk), and on the card each scan is one kernel launch.

    Returns (state, outputs): a StepOutput with a leading T axis;
    ``overlay`` is (T, Hc, Wc, 3) when ``with_overlay`` else None.
    """
    mode = second_attempt or "cond"
    if mode not in MODES:
        raise ValueError(f"unknown second_attempt mode {mode!r}")
    hoist = mode == "hoist"
    with unit("lt.chunk", frames.shape[0]):
        arts = front_artifacts_batch(frames, params, config,
                                     hoist_second_attempt=hoist)
        if isinstance(frames, StreamedChunk):
            frames = frames.frames
        if mode == "two_phase" and has_second_attempt(config):
            state, (outs, metas) = two_phase_scan(state, arts, params,
                                                  config)
        else:
            with span("lt.back_half"):
                state, (outs, metas) = scan_back_half(state, arts, params,
                                                      config)
        if with_overlay:
            with span("lt.overlay"):
                outs = outs._replace(overlay=render_frame(
                    frames, metas, params, config))
    return state, outs


@functools.lru_cache(maxsize=16)
def build_chunk_processor(config: TrackerConfig, with_overlay: bool = True,
                          hoist_second_attempt: bool = False,
                          second_attempt: str | None = None):
    """The chunk processor ``fn(state, frames, params)`` of a static
    config, cached per config and options (the reference's jit-compiled
    processor, lane_tracker_tpu/parallel/pipeline.py:138).
    ``hoist_second_attempt=True`` is the reference's older spelling of
    ``second_attempt='hoist'``."""
    mode = second_attempt or ("hoist" if hoist_second_attempt else "cond")
    if mode not in MODES:
        raise ValueError(f"unknown second_attempt mode {mode!r}")

    def fn(state, frames, params):
        return chunk_process(state, frames, params, config, with_overlay,
                             mode)

    return fn
