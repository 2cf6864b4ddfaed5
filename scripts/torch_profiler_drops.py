"""Does a torch.profiler trace hold every kernel its calls launch?

Times 10 calls of the port's ``tile_gather`` (G1, 16 reps) under the
profiler, 8 traces a setting, in a fresh process and again after 60 s and
120 s of launches outside any trace; each setting with and without 50 ms
of idle before and after the calls inside the trace.  Prints one JSON line
a setting: the tile_gather kernels each trace holds, the runtime's launch
calls it holds, and how far after the first launch call the first kernel
starts (us).  Needs CUDA.

    python3 scripts/torch_profiler_drops.py
"""

import json
import pathlib
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lane_tracker_tpu_torch.device import entry_device  # noqa: E402
from lane_tracker_tpu_torch.kernels import tile_gather as tg  # noqa: E402
from lane_tracker_tpu_torch.kernels.build import build  # noqa: E402

CALLS = 10
TRACES = 8
BUSY_UNTIL_S = (60, 120)


def trace(fn, idle_s):
    """(kernels, launch calls, first kernel - first launch call in us) of
    one trace of CALLS calls."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(idle_s)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(idle_s)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [ev for ev in events
               if ev.get("cat") == "kernel" and "tile_gather" in ev["name"]]
    launches = [ev for ev in events if ev.get("cat") == "cuda_runtime"
                and "Launch" in ev["name"]]
    offset = (min(ev["ts"] for ev in kernels)
              - min(ev["ts"] for ev in launches)
              if kernels and launches else None)
    return len(kernels), len(launches), offset


def main():
    entry_device("cuda")
    build()
    src, li, si = tg.make_inputs("cuda")

    def fn():
        return tg.tile_gather(src, li, si, "G1_lane_gather", tg.REPS[0])

    fn()
    torch.cuda.synchronize()
    t0 = time.time()

    def sweep(tag):
        for idle_s in (0, 0.05):
            res = [trace(fn, idle_s) for _ in range(TRACES)]
            print(json.dumps({
                "t_s": round(time.time() - t0), "after": tag,
                "idle_s": idle_s, "kernels": [r[0] for r in res],
                "launch_calls": [r[1] for r in res],
                "first_kernel_after_first_launch_us": [r[2] for r in res],
            }), flush=True)

    sweep("fresh")
    for until in BUSY_UNTIL_S:
        while time.time() - t0 < until:  # launches outside any trace
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
        sweep(f"{until} s of launches")


if __name__ == "__main__":
    main()
