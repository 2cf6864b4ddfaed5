"""The program's own spans and counters, read with the profiler off.

A traced run's per-layer readers of the ``program_span`` and
``program_counter`` metrics read one stretch of ``trace_units`` chunks or
steps run inside ``lane_tracker_tpu_torch.utils.profiling.recording()``
with no profiler: spans on the program's own clock
(``time.perf_counter_ns``), counters as the program counts them.  The
stretch's ``summary()`` (``spans``: ``n``, ``total_ns``, ``self_ns`` a
name; ``counters``; ``units``) is what they read.

The stretch runs in a fresh process (``python -m benchmark.program``):
the same cell, seed and sizes, set up and warmed up as ``run_cell`` does.
A process that has run a ``torch.profiler`` stretch launches more slowly
after it, and more so as it goes on (PERF.md §5), so the run's own
process, whose profiled stretch comes first, cannot time the program
unprofiled.  The readers get only the trace reading from
``harness.run_cell``; the first that asks finds the run's cell in
``run_cell``'s frame, runs the stretch once and keeps the summary on the
reading (``reading.program``).  Outside a traced ``run_cell``, or against
a program without ``recording`` (an older checkout), the summary is None
and the readers return nothing.  A stretch whose ``lt.frames`` differs
from the frames the entry ran fails the run, as a trace that drops a
launch does.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def stretch(reading):
    """The program stretch's summary for this traced run, or None."""
    if not hasattr(reading, "program"):
        reading.program = _run()
    return reading.program


def span_ms_per_frame(reading, name: str):
    """Span ``name``'s total ms a frame of the stretch, or None where it
    never opened."""
    s = stretch(reading)
    if s is None or not s["counters"].get("lt.frames"):
        return None
    row = s["spans"].get(name)
    if row is None:
        return None
    return row["total_ns"] / 1e6 / s["counters"]["lt.frames"]


def count_per_frame(reading, name: str):
    """Counter ``name`` a frame of the stretch (0 where it never
    counted), or None without a stretch."""
    s = stretch(reading)
    if s is None or not s["counters"].get("lt.frames"):
        return None
    return s["counters"].get(name, 0) / s["counters"]["lt.frames"]


def _run_cell_locals():
    """The locals of the traced ``harness.run_cell`` that called the
    readers, or None."""
    f = sys._getframe(1)
    while f is not None:
        if (f.f_code.co_name == "run_cell"
                and f.f_globals.get("__name__") == "benchmark.harness"):
            run = f.f_locals
            return run if run.get("traced") else None
        f = f.f_back
    return None


def _run():
    from lane_tracker_tpu_torch.utils import profiling

    run = _run_cell_locals()
    if run is None or not hasattr(profiling, "recording"):
        return None
    from benchmark import harness

    cmd = [sys.executable, "-m", "benchmark.program",
           "--workload", run["name"], "--seed", str(run["seed"]),
           "--device", str(run["device"]),
           "--config", json.dumps(run["config_override"] or {}),
           "--mix", json.dumps(run["mix_override"] or {})]
    proc = subprocess.run(cmd, cwd=run["root"], stdout=subprocess.PIPE,
                          text=True, timeout=1800, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    summary = out["summary"]
    counted = summary["counters"].get("lt.frames", 0)
    if counted != out["frames"]:
        raise harness.TraceIncomplete(
            f"the program counted {counted} frames where the entry ran "
            f"{out['frames']}")
    harness.log(f"program stretch: {json.dumps(summary)}")
    return summary


def main(argv) -> int:
    """Set up the cell as ``run_cell`` does, warm it up, run
    ``trace_units`` units inside a recording, and print the frames the
    entry ran and the summary as one JSON line."""
    ap = argparse.ArgumentParser(prog="python -m benchmark.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--config", default="{}",
                    help="JSON: top-level keys of the configuration to "
                    "replace")
    ap.add_argument("--mix", default="{}",
                    help="JSON: top-level keys of the mix to replace")
    args = ap.parse_args(argv)
    import torch

    from benchmark import cell, harness
    from lane_tracker_tpu_torch.utils import profiling

    here = ROOT / "benchmark"
    bench = cell.load_benchmark(ROOT)
    wl = cell.workload(bench, args.workload)
    cfg = cell.config(here, wl["config"])
    cfg.update(json.loads(args.config))
    mix = cell.mix(here, wl["traffic"])
    mix.update(json.loads(args.mix))
    device = torch.device(args.device)
    if device.type == "cuda":
        from lane_tracker_tpu_torch.kernels.build import load_library

        load_library()
    sync = harness._sync(device)
    entry = cell.entry(here, cfg).Entry(cfg, mix, args.seed, device, ROOT,
                                       cell.generator(here, mix),
                                       harness.Phases())
    entry.warm_up()
    sync()
    frames = 0
    with profiling.recording():
        for _ in range(int(cfg["trace_units"])):
            frames += entry.unit()
        sync()
    print(json.dumps({"frames": frames, "summary": profiling.summary()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
