#!/usr/bin/env python3
"""Serving latency against throughput on one GPU: the chunk-size trade.

The port of scripts/latency_bench.py:27-149.  A frame entering an empty
chunk waits for T frames to arrive and then one chunk's compute before
its overlay exists; small chunks cut the wait at some frames/s (per-chunk
set-up stops amortizing).  One row per chunk size T and pipeline
('corridor', then 'fast'): demo1, two_phase, overlay on, the four stills
cycled, frames on the card, state carried from chunk to chunk.

Each row first runs one chunk from a fresh state and asserts every frame
valid and, in 'corridor', every frame's ``corridor_ok``; then it times
chunks with a CUDA event pair each, as many as make at least about
``MIN_SECONDS`` (2 s) after one chunk that sizes the count, and reports
the median.  ``chunk_compute_ms`` is the compute part of a frame's latency
(the queueing part, T over the camera's frame rate, belongs to the camera).

    python scripts/torch_latency_bench.py [T ...]

(default sizes 1 2 4 8 16 64 256 512).
``LATENCY_ROWMM=1`` runs the row-matmul resampler
(``TrackerParams.with_rowmm``) on every row asked for, each tagged
``"resampler": "rowmm"``.  Prints one JSON line a row, the card beside it;
writes no file.  Without CUDA it raises.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

# The repository's root: bench_torch.py and the package.
import bench_torch as bt  # noqa: E402
from lane_tracker_tpu_torch.device import (  # noqa: E402
    DEFAULT_DEVICE,
    entry_device,
)
from lane_tracker_tpu_torch.parallel.pipeline import (  # noqa: E402
    build_chunk_processor,
)
from lane_tracker_tpu_torch.tracker.config import PRESETS  # noqa: E402
from lane_tracker_tpu_torch.tracker.step import (  # noqa: E402
    make_initial_state,
)

SIZES = (1, 2, 4, 8, 16, 64, 256, 512)
PIPELINES = ("corridor", "fast")
MIN_SECONDS = 2.0
MIN_CHUNKS = 3


def measure(params, T: int, device) -> dict:
    """One row: the checked chunk, then the timed chunks."""
    config = PRESETS["demo1"]
    step = build_chunk_processor(config, with_overlay=True,
                                 second_attempt="two_phase")
    frames = torch.from_numpy(bt.cycled_stills(T)).to(device)
    state, outs = step(make_initial_state(config, params.warped_size, device),
                       frames, params)
    if not bool(outs.valid.all()):
        raise AssertionError(f"tracking failed at T={T}")
    if params.pipeline == "corridor" and not bool(outs.corridor_ok.all()):
        raise AssertionError(f"corridor certificate failed at T={T}")
    del outs
    bt.release(device)
    # One chunk sizes the count, as latency_bench.py sizes its chained
    # iterations by one eager call.
    state, first_ms, _ = bt.timed_call(
        lambda: step(state, frames, params)[0], device)
    n = max(MIN_CHUNKS, math.ceil(MIN_SECONDS * 1e3 / max(first_ms, 1e-3)))
    bt.reset_peak(device)
    chunk_ms, wall_ms = [], []
    for _ in range(n):
        state, ms, wall = bt.timed_call(
            lambda: step(state, frames, params)[0], device)
        chunk_ms.append(ms)
        wall_ms.append(wall)
    ev = bt.spread(chunk_ms)
    return {
        "pipeline": params.pipeline,
        "chunk": T,
        "fps": T / (ev["median"] / 1e3),
        "ms_per_frame": ev["median"] / T,
        "chunk_compute_ms": ev["median"],
        "chunk_ms_min": ev["min"],
        "chunk_ms_max": ev["max"],
        "wall_ms_median": float(np.median(wall_ms)),
        "timed_chunks": n,
        "peak_mem_gib": bt.peak_gib(device),
    }


def main(argv, device=DEFAULT_DEVICE):
    """Measure every (pipeline, T) row, print each as one JSON line and
    return the rows."""
    device = entry_device(device)
    sizes = [int(a) for a in argv] or list(SIZES)
    rowmm = bool(int(os.environ.get("LATENCY_ROWMM", "0")))
    dev = bt.card(device)
    rows = []
    for pipeline in PIPELINES:
        params = bt.build_params(pipeline, device)
        if rowmm:
            params = params.with_rowmm()
        for T in sizes:
            rec = measure(params, T, device)
            if rowmm:
                rec["resampler"] = "rowmm"
            rec["device"] = dev
            rows.append(rec)
            print(json.dumps(rec), flush=True)
            bt.release(device)
        del params
        bt.release(device)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
