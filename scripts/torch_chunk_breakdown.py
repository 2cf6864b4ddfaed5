"""Where a chunk's time goes in the PyTorch port, on one NVIDIA GPU.

Runs the port's main path (demo1, 'corridor', two_phase, overlay on) on a
chunk of the four stills cycled to T frames, state carried, and reports:

* the chunk's time without the profiler: CUDA events around each of
  ``--reps`` chunks;
* a ``torch.profiler`` trace of ``--reps`` more chunks, read through the
  ``lt.<stage>`` ranges that ``chunk_process`` and ``front_artifacts_batch``
  open (warp_lab, filter, embed_search, back_half, overlay): per chunk, the
  host time spent inside each range, and the device time and number of the
  kernels launched from it.  Kernels are tied to the range their launch
  call sits in through the trace's correlation ids, so the filter stage's
  ctypes-launched CUDA kernels count as well as PyTorch's own;
* from the same trace: device busy time (the sum of kernel, memcpy and
  memset times on the one stream), the idle share against the profiled and
  the unprofiled chunk time, and the top kernels by time.

Usage (from the repository root):

    python3 scripts/torch_chunk_breakdown.py [--T 64] [--reps 3]

Writes the numbers to chiprun_out/torch_chunk_breakdown.json as well.
Exits non-zero without CUDA.
"""

import argparse
import bisect
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
STAGES = ("lt.warp_lab", "lt.filter", "lt.embed_search", "lt.back_half",
          "lt.overlay")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def stage_table(events, reps):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lane_tracker_tpu_torch.calib.io import load_calibration_npz
    from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
    from lane_tracker_tpu_torch.tracker.config import PRESETS
    from lane_tracker_tpu_torch.tracker.step import (
        TrackerParams,
        make_initial_state,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor")
    cfg = PRESETS["demo1"]
    with np.load(REPO / "assets" / "stills_720p.npz") as z:
        stills = z["frames"]
    frames = torch.from_numpy(stills[np.arange(args.T) % len(stills)]).cuda()
    state = make_initial_state(cfg, params.warped_size)
    state, _ = chunk_process(state, frames, params, cfg)  # warm-up

    chunk_ms = []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        state, _ = chunk_process(state, frames, params, cfg)
        end.record()
        torch.cuda.synchronize()
        chunk_ms.append(start.elapsed_time(end))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            state, _ = chunk_process(state, frames, params, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps
    trace = REPO / "build" / "torch_chunk_breakdown_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    stages = stage_table(events, args.reps)
    missing = [s for s in STAGES if stages[s]["host_ms"] == 0.0]
    if missing:
        print(f"profile has no ranges {missing}", file=sys.stderr)
        return 1
    per_kernel = collections.defaultdict(lambda: [0, 0.0])
    for ev in events:
        if ev.get("cat") in DEVICE_CATS:
            per_kernel[ev["name"]][0] += 1
            per_kernel[ev["name"]][1] += ev["dur"] / 1e3
    busy_ms = sum(v["device_ms"] for v in stages.values())
    launches = sum(v["launches"] for v in stages.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    chunk_ms_median = statistics.median(chunk_ms)
    result = {
        "card": card,
        "T": args.T,
        "reps": args.reps,
        "chunk_ms": chunk_ms,
        "chunk_ms_median": chunk_ms_median,
        "profiled_chunk_wall_ms": wall_ms,
        "stages_per_chunk": stages,
        "device_busy_ms_per_chunk": busy_ms,
        "device_idle_share_profiled": 1.0 - busy_ms / wall_ms,
        "device_idle_share_unprofiled": 1.0 - busy_ms / chunk_ms_median,
        "launches_per_chunk": launches,
        "top_kernels": [{"name": name[:90], "count": n, "device_ms": ms}
                        for name, (n, ms) in top],
    }
    print(f"chunk_process T={args.T}: {chunk_ms} ms, median "
          f"{chunk_ms_median} ms ({card})")
    print(f"profiled, per chunk: wall {wall_ms} ms, device busy {busy_ms} ms, "
          f"idle share {result['device_idle_share_profiled']} (against the "
          f"unprofiled median {result['device_idle_share_unprofiled']}), "
          f"{launches} launches")
    for k, v in stages.items():
        print(f"  {k:16s} host {v['host_ms']:10.3f} ms  device "
              f"{v['device_ms']:9.3f} ms  launches {v['launches']:9.1f}")
    for e in result["top_kernels"]:
        print(f"  {e['device_ms']:8.3f} ms  x{e['count']:5d}  {e['name']}")
    out = REPO / "chiprun_out" / "torch_chunk_breakdown.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
