"""Chunked pipeline: batched front half, sequential back half, overlays.

Port of lane_tracker_tpu/parallel/pipeline.py:42-134.  A chunk of T frames
runs the stateless front half (warp, LAB, the three filter kernels,
sliding-window precompute) once on the whole batch, then the back half as
a Python loop over frames carrying the tracker state, then the overlays
for all T frames at once.

Only ``second_attempt="two_phase"`` is ported, and only its first phase:
when some frame's first attempt fails, the reference reruns the chunk
with the batched second attempt; here that raises ``NotImplementedError``
(the second attempt is the next slice), on the CPU and the card alike.

Each stage runs inside a ``torch.profiler.record_function`` range named
``lt.<stage>`` (warp_lab, filter, embed_search, back_half, overlay);
scripts/torch_chunk_breakdown.py reads them from a profile.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from lane_tracker_tpu_torch.tracker.config import TrackerConfig
from lane_tracker_tpu_torch.tracker.state import TrackerState
from lane_tracker_tpu_torch.tracker.step import (
    FrontArtifacts,
    TrackerParams,
    back_half,
    front_artifacts_batch,
    render_frame,
)


def _stack(items: list):
    """Stack a list of same-type NamedTuples field by field."""
    cls = type(items[0])
    return cls(*(None if fs[0] is None else torch.stack(fs)
                 for fs in zip(*items)))


def scan_back_half(state: TrackerState, arts: FrontArtifacts,
                   params: TrackerParams, config: TrackerConfig):
    """The back half over the chunk's frames in order.  Returns
    (state, (StepOutput stack, RenderMeta stack)) with a leading T axis."""
    outs, metas = [], []
    for t in range(arts.pref.packed.shape[0]):
        iv_t = type(arts.iv_sws)(*(f[t] for f in arts.iv_sws))
        pref_t = type(arts.pref)(arts.pref.packed[t])
        state, out, meta = back_half(state, pref_t, iv_t, params, config)
        outs.append(out)
        metas.append(meta)
    return state, (_stack(outs), _stack(metas))


def two_phase_scan(state: TrackerState, arts: FrontArtifacts,
                   params: TrackerParams, config: TrackerConfig):
    """Phase 1 of the reference's two_phase schedule: scan attempt 1 only.
    One host check per chunk decides whether phase 2 (the batched second
    attempt and a rescan) is needed; it is not ported and raises."""
    cfg1 = dataclasses.replace(config, n_tries=1)
    st1, (outs1, metas1) = scan_back_half(state, arts, params, cfg1)
    if not bool(outs1.valid.all()):
        bad = (~outs1.valid).nonzero().flatten().tolist()
        raise NotImplementedError(
            f"attempt 1 failed on frames {bad} of the chunk: the two_phase "
            "fallback (the second-attempt slice: 'neighborhood' filter + "
            "rescan) is not ported yet")
    return st1, (outs1, metas1)


def chunk_process(state: TrackerState, frames: torch.Tensor,
                  params: TrackerParams, config: TrackerConfig,
                  with_overlay: bool = True,
                  second_attempt: str = "two_phase"):
    """Process a (T, Hc, Wc, 3) uint8 chunk on ``frames.device``.

    Returns (state, outputs): a StepOutput with a leading T axis;
    ``overlay`` is (T, Hc, Wc, 3) when ``with_overlay`` else None.
    """
    if second_attempt != "two_phase":
        raise NotImplementedError(
            f"second_attempt={second_attempt!r}: only 'two_phase' is ported")
    arts = front_artifacts_batch(frames, params, config)
    with record_function("lt.back_half"):
        if config.n_tries >= 2 or config.n_tries == -1:
            state, (outs, metas) = two_phase_scan(state, arts, params, config)
        else:
            state, (outs, metas) = scan_back_half(state, arts, params, config)
    if with_overlay:
        with record_function("lt.overlay"):
            outs = outs._replace(overlay=render_frame(frames, metas, params,
                                                      config))
    return state, outs

