"""Tracing and throughput observability: the port's one tracing module.

Port of lane_tracker_tpu/utils/profiling.py:1-53, with the port's own
spans and counters:

* :func:`maybe_profile` wraps a region in a ``torch.profiler`` trace
  (the CPU, and the card where CUDA is available) when a directory is
  given, and writes it there as a Chrome trace (``trace.json``), the
  counterpart of the reference's ``jax.profiler`` trace.  It is the only
  exporter: nothing else here writes a file.
* :func:`span` is the one way the program opens an ``lt.*`` range.  With
  no profiler active and no recording open it returns one shared no-op
  context (a flag check and a call).  Under a profiler it opens
  ``record_function(name)``, so the range shares the device trace's
  clock; inside :func:`recording` it also keeps the span in memory (name,
  parent, unit, start and end by ``time.perf_counter_ns``).
* :func:`unit` opens the root span of one unit of work (a chunk, a fleet
  step, a frame) where no span is open yet, and counts its frames in
  ``lt.frames``; nested inside another unit it is a no-op.
* :func:`count` adds to a process-wide counter while a recording is open.
* :func:`host_read` copies a device value to the host inside an
  ``lt.host_read`` span and counts it in ``lt.host_reads``: every read
  the program waits on goes through it.
* :func:`recording` opens a recording (clearing the last one),
  :func:`summary` sums it by span name, :func:`spans` lists its spans.
* :class:`FpsMeter` is a lightweight frames/sec meter for frame loops, copied
  from the reference (tests/test_torch_host.py pins it equal).

Spans and counters are kept for one thread: the port queues its work
from one.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NULL = contextlib.nullcontext()


class _Recorder:
    """The open recording's spans and counters, and the spans open now.

    ``spans`` holds one ``[name, parent, unit, start_ns, end_ns]`` a span
    (``parent`` an index into ``spans`` or -1, ``end_ns`` 0 while open);
    a span opened with no recorded span open is a root, and its number
    among the roots is the ``unit`` of every span under it."""

    def __init__(self):
        self.depth = 0  # recording() nesting; > 0 while recording
        self.open_spans = 0  # spans entered and not yet left, traced or not
        self.spans = []
        self.stack = []
        self.counters = {}
        self.units = 0

    def clear(self):
        self.spans, self.stack, self.counters, self.units = [], [], {}, 0

    def enter(self, name: str) -> int:
        if self.stack:
            parent = self.stack[-1]
            unit = self.spans[parent][2]
        else:
            parent, unit = -1, self.units
            self.units += 1
        self.spans.append([name, parent, unit, time.perf_counter_ns(), 0])
        self.stack.append(len(self.spans) - 1)
        return self.stack[-1]

    def leave(self, i: int) -> None:
        self.spans[i][4] = time.perf_counter_ns()
        self.stack.pop()


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "_range", "_index")

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._index = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        if _REC.depth:
            self._index = _REC.enter(self.name)
        _REC.open_spans += 1
        return self

    def __exit__(self, *exc):
        _REC.open_spans -= 1
        if self._index is not None:
            _REC.leave(self._index)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """The ``lt.*`` range ``name`` as a context manager (module
    docstring); the shared no-op while nothing traces."""
    if not _REC.depth and not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name)


def unit(name: str, frames: int):
    """The root span ``name`` of one unit of ``frames`` frames, counted in
    ``lt.frames``; the no-op where a span is already open, so that an
    entry point called by another is not a unit of its own."""
    if _REC.open_spans:
        return _NULL
    root = span(name)
    if root is not _NULL:
        count("lt.frames", frames)
    return root


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a recording is open."""
    if _REC.depth:
        _REC.counters[name] = _REC.counters.get(name, 0) + int(n)


def host_read(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host: a read of a device value that the host waits
    for, in an ``lt.host_read`` span and counted in ``lt.host_reads``."""
    with span("lt.host_read"):
        count("lt.host_reads")
        return x.cpu()


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block.  The outermost
    recording clears the last one's; :func:`summary` and :func:`spans`
    read it after the block."""
    if not _REC.depth:
        _REC.clear()
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1


def spans() -> list[dict]:
    """The recording's spans in the order they opened: ``name``,
    ``parent`` (an index into this list, or -1), ``unit``, ``start_ns``
    and ``end_ns`` (0 while open)."""
    keys = ("name", "parent", "unit", "start_ns", "end_ns")
    return [dict(zip(keys, s)) for s in _REC.spans]


def summary() -> dict:
    """The recording summed: ``spans`` maps each name to ``n``,
    ``total_ns`` and ``self_ns`` (its spans' durations less what their
    child spans cover), over closed spans; ``counters`` the counters;
    ``units`` the number of root spans."""
    children = [0] * len(_REC.spans)
    for _, parent, _, t0, t1 in _REC.spans:
        if parent >= 0 and t1:
            children[parent] += t1 - t0
    out = {}
    for i, (name, _, _, t0, t1) in enumerate(_REC.spans):
        if not t1:
            continue
        row = out.setdefault(name, {"n": 0, "total_ns": 0, "self_ns": 0})
        row["n"] += 1
        row["total_ns"] += t1 - t0
        row["self_ns"] += t1 - t0 - children[i]
    return {"spans": out, "counters": dict(_REC.counters),
            "units": _REC.units}


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
