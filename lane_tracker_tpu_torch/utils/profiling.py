"""Tracing and throughput observability.

Port of lane_tracker_tpu/utils/profiling.py:1-53:

* :func:`maybe_profile` wraps a region in a ``torch.profiler`` trace
  (the CPU, and the card where CUDA is available) when a directory is
  given, and writes it there as a Chrome trace (``trace.json``), the
  counterpart of the reference's ``jax.profiler`` trace.
* :func:`trace_annotation` names pipeline stages inside traces.
* :class:`FpsMeter` is a lightweight frames/sec meter for frame loops, copied
  from the reference (tests/test_torch_host.py pins it equal).
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def maybe_profile(trace_dir=None):
    if not trace_dir:
        yield
        return
    out = pathlib.Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def trace_annotation(name: str):
    """Named region inside traces (no-op overhead outside tracing)."""
    return record_function(name)


class FpsMeter:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.frames = 0

    def add(self, n: int):
        self.frames += int(n)

    def fps(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.frames / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.perf_counter()
        self.frames = 0
