"""The traced stretch: ``torch.profiler`` events reduced to per-layer
numbers.

``stage_table`` is a frozen copy of scripts/torch_chunk_breakdown.py:40-66
(commit 6cc3612) with ``lt.second_attempt`` among the stages: each
``lt.<stage>`` range's host time, and the device time and number of the
device operations launched inside it, tied to it by the correlation ids
of their launch calls.  ``busy_seconds`` is the union of the device's
kernels, copies and sets, ``breakdown`` the device operations that took
most time and the longest idle gaps by the host range they fell in.
"""

from __future__ import annotations

import bisect
import collections
import json
import pathlib

STAGES = ("lt.warp_lab", "lt.filter", "lt.embed_search", "lt.second_attempt",
          "lt.back_half", "lt.overlay")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# The filter library's kernels (lane_tracker_tpu_torch/csrc/), which
# kernels.filter_stage.kernel_launches() counts.
HAND_KERNELS = ("tophat_kernel", "threshold_kernel", "open_tail_kernel",
                "adaptive_mean_kernel")


def stage_table(events, reps=1):
    """Per-chunk host ms, device ms and launches of each ``lt.`` range, from
    the events of a chrome trace; device work launched outside every range
    goes to ``(outside)``."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in STAGES)
    starts = [s for s, _, _ in spans]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in LAUNCH_CATS
                   and "correlation" in e.get("args", {})}
    table = {name: {"host_ms": 0.0, "device_ms": 0.0, "launches": 0.0}
             for name in STAGES + ("(outside)",)}
    for s, e, name in spans:
        table[name]["host_ms"] += (e - s) / 1e3 / reps
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS:
            continue
        ts = launched_at.get(ev.get("args", {}).get("correlation"))
        i = -1 if ts is None else bisect.bisect_right(starts, ts) - 1
        name = spans[i][2] if i >= 0 and ts < spans[i][1] else "(outside)"
        table[name]["device_ms"] += ev["dur"] / 1e3 / reps
        table[name]["launches"] += 1 / reps
    return table


def events_from_profile(prof, scratch: pathlib.Path) -> list[dict]:
    """The profile's events as chrome-trace dicts (``cat``, ``name``,
    ``ts`` and ``dur`` in us, ``args.correlation``), written to
    ``scratch`` and read back, then deleted."""
    scratch.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(scratch))
    try:
        return json.loads(scratch.read_text())["traceEvents"]
    finally:
        scratch.unlink()


def device_intervals(events) -> list[tuple[float, float]]:
    """The union of the device operations' [start, end) in us, sorted."""
    ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS)
    merged = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(events) -> float:
    return sum(e - s for s, e in device_intervals(events)) / 1e6


def hand_kernel_events(events) -> list[dict]:
    return [e for e in events if e.get("cat") == "kernel"
            and any(k in e.get("name", "") for k in HAND_KERNELS)]


def hand_kernel_name(ev: dict) -> str:
    return next(k for k in HAND_KERNELS if k in ev["name"])


def breakdown(events, t0_us: float, t1_us: float, top: int = 10) -> dict:
    """The ``top`` device operations by summed seconds, and the ``top``
    host ranges by the idle seconds between device operations inside
    [t0_us, t1_us) that fell while the range was open."""
    by_op = collections.Counter()
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            by_op[e["name"][:120]] += e["dur"] / 1e6
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in STAGES)
    starts = [s for s, _, _ in spans]
    gaps = collections.Counter()
    prev = t0_us
    for s, e in device_intervals(events) + [(t1_us, t1_us)]:
        if s > prev:
            i = bisect.bisect_right(starts, prev) - 1
            name = spans[i][2] if i >= 0 and prev < spans[i][1] else (
                "(outside)")
            gaps[name] += (min(s, t1_us) - prev) / 1e6
        prev = max(prev, e)
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}


class TraceReading:
    """What the per-layer readers read: the stage table over the traced
    stretch (totals, not per chunk), the frames the stretch processed, its
    wall seconds, the device's busy seconds, the hand kernels' events and
    the shapes the roofline functions take (``shapes``)."""

    def __init__(self, events, frames: int, window_s: float, shapes: dict):
        self.stages = stage_table(events)
        self.frames = int(frames)
        self.window_s = float(window_s)
        self.busy_s = busy_seconds(events)
        self.hand = hand_kernel_events(events)
        self.shapes = shapes

    def per_frame(self, stage: str, key: str):
        """The stage's ``key`` a frame, or None where the stretch never
        entered the stage."""
        row = self.stages[stage]
        if row["host_ms"] == 0.0 and row["launches"] == 0.0:
            return None
        return row[key] / self.frames
