#!/usr/bin/env python3
"""Fleet throughput on one GPU: S streams stepped in lockstep, under four
loads and three second-attempt schedules.

The port of scripts/fleet_bench.py:33-179.  ``StreamFleet`` (each step
one call of ``build_fleet_processor``'s function) over ``stream_mesh(1)``,
demo1, overlay on, stream s the four stills cycled from still s, frames
on the card.  The loads:

  all_valid     every frame tracks; two_phase's fallback never runs
  fail16        every 16th frame of stream 0 black: one stream poisons
                every step of the whole fleet
  fail16_all    every 16th frame of every stream black
  dead_stream   stream 0 black throughout (a dead camera)

Each runs under 'two_phase', 'hoist' and 'auto'.  'auto' first steps a
``StreamFleet(second_attempt='auto')`` 8 times under the load, so that its
controller settles, and then times the schedule it resolved to
(``resolved_schedule``).  A row: one step from a fresh state gives the
load's valid fraction, then ``TIMED_STEPS`` steps with the states carried,
a CUDA event pair each; ``aggregate_fps`` is S * T over the median step.

    python scripts/torch_fleet_bench.py [S T ...]     # default 8 32

``FLEET_PIPELINE`` (default 'fast'), ``FLEET_SCHEDULES`` and
``FLEET_LOADS`` (comma-separated) select as in fleet_bench.py.  Prints one
JSON line a (load, schedule) pair, the card beside it; writes no file.
Without CUDA it raises.
"""

from __future__ import annotations

import json
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
from lane_tracker_tpu_torch.parallel import (  # noqa: E402
    StreamFleet,
    stream_mesh,
)

LOADS = ("all_valid", "fail16", "fail16_all", "dead_stream")
SCHEDULES = ("two_phase", "hoist", "auto")
TIMED_STEPS = 8
# EMA(0.25) after 8 poisoned steps: 1 - 0.75^8 = 0.90, past the 0.81
# crossover.
AUTO_STEPS = 8


def load_frames(S: int, T: int) -> dict:
    """Each load's (S, T, 720, 1280, 3) uint8 frames on the host."""
    base = np.stack([bt.cycled_stills(T, s) for s in range(S)])
    loads = {"all_valid": base}
    loads["fail16"] = base.copy()
    loads["fail16"][0, ::16] = 0
    loads["fail16_all"] = base.copy()
    loads["fail16_all"][:, ::16] = 0
    loads["dead_stream"] = base.copy()
    loads["dead_stream"][0] = 0
    return loads


def resolve_auto(params, config, mesh, frames) -> str:
    """The schedule 'auto' settles on after ``AUTO_STEPS`` steps under a
    load."""
    fleet = StreamFleet(params, config, frames.shape[0], mesh=mesh,
                        with_overlay=True, second_attempt="auto")
    for _ in range(AUTO_STEPS):
        fleet.step(frames)
    return fleet.schedule


def measure(params, config, mesh, frames, schedule: str):
    """A fleet's first step from fresh states (its outputs and metrics),
    then ``TIMED_STEPS`` timed steps with the states carried: (outs,
    metrics, step ms, wall ms, peak GiB)."""
    device = mesh[0]
    fleet = StreamFleet(params, config, frames.shape[0], mesh=mesh,
                        with_overlay=True, second_attempt=schedule)
    outs, metrics = fleet.step(frames)
    bt.reset_peak(device)
    step_ms, wall_ms = [], []
    for _ in range(TIMED_STEPS):
        _, ms, wall = bt.timed_call(lambda: fleet.step(frames), device)
        step_ms.append(ms)
        wall_ms.append(wall)
    return outs, metrics, step_ms, wall_ms, bt.peak_gib(device)


def main(argv, device=DEFAULT_DEVICE):
    """Measure every (S, T), load and schedule; print each row as one
    JSON line and return the rows."""
    device = entry_device(device)
    pipeline = os.environ.get("FLEET_PIPELINE", "fast")
    params = bt.build_params(pipeline, device)
    config = bt.bench_config(pipeline)
    mesh = (stream_mesh(1) if device.type == "cuda"
            else stream_mesh(devices=(device,)))
    configs = ([(int(argv[i]), int(argv[i + 1]))
                for i in range(0, len(argv), 2)] if argv else [(8, 32)])
    schedules = [s for s in SCHEDULES if s in os.environ.get(
        "FLEET_SCHEDULES", ",".join(SCHEDULES)).split(",")]
    wanted = os.environ.get("FLEET_LOADS", ",".join(LOADS)).split(",")
    dev = bt.card(device)
    rows = []
    for S, T in configs:
        loads = {k: v for k, v in load_frames(S, T).items() if k in wanted}
        for schedule in schedules:
            for load, host_frames in loads.items():
                frames = torch.from_numpy(host_frames).to(device)
                resolved = schedule
                if schedule == "auto":
                    resolved = resolve_auto(params, config, mesh, frames)
                outs, metrics, step_ms, wall_ms, peak = measure(
                    params, config, mesh, frames, resolved)
                med = float(np.median(step_ms))
                rec = {
                    "streams": S, "chunk": T,
                    "schedule": schedule, "load": load,
                    **({"resolved_schedule": resolved}
                       if schedule == "auto" else {}),
                    "aggregate_fps": S * T / (med / 1e3),
                    "ms_per_frame": med / (S * T),
                    "step_ms_median": med,
                    "step_ms_min": float(min(step_ms)),
                    "step_ms_max": float(max(step_ms)),
                    "wall_ms_median": float(np.median(wall_ms)),
                    "timed_steps": len(step_ms),
                    "valid_fraction": (int(metrics["valid_frames"])
                                       / int(metrics["frames"])),
                    "peak_mem_gib": peak,
                    **({"pipeline": pipeline} if pipeline != "fast" else {}),
                    "device": dev,
                }
                rows.append(rec)
                print(json.dumps(rec), flush=True)
                del outs, metrics, frames
                bt.release(device)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
