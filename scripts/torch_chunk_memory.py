#!/usr/bin/env python3
"""Peak device memory of the port's chunk at the bench's T=512.

Runs ``parallel.pipeline.chunk_process`` (demo1, two_phase, overlay on,
fresh state) on the 512-frame stills chunk (assets/stills_720p.npz
cycled) in the 'corridor' and 'fast' pipelines.  One JSON row a
pipeline: the peak of ``torch.cuda.max_memory_allocated()``, the run's
wall ms (one first run, not a timing claim) and the card's name and
power limit.  A run that exceeds the card's memory prints ``"fits": false`` and the
script goes on.  Needs one CUDA device.

Usage: python3 scripts/torch_chunk_memory.py [--frames 512]
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from lane_tracker_tpu_torch.calib.io import load_calibration_npz  # noqa: E402
from lane_tracker_tpu_torch.kernels.build import build  # noqa: E402
from lane_tracker_tpu_torch.parallel.pipeline import chunk_process  # noqa: E402
from lane_tracker_tpu_torch.tracker import step  # noqa: E402
from lane_tracker_tpu_torch.tracker.config import PRESETS  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_chunk_memory: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    build()
    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")
    cfg = PRESETS["demo1"]
    with np.load(REPO / "assets" / "stills_720p.npz") as z:
        stills = z["frames"]
    frames = torch.from_numpy(
        stills[np.arange(args.frames) % len(stills)]).cuda()
    for pipeline in ("corridor", "fast"):
        params = step.TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph, pipeline=pipeline)

        def run():
            return chunk_process(
                step.make_initial_state(cfg, params.warped_size, "cuda"),
                frames, params, cfg, with_overlay=True,
                second_attempt="two_phase")[1]

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = {"pipeline": pipeline, "frames": args.frames, "card": card}
        t0 = time.perf_counter()
        try:
            out = run()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            row.update(fits=False,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        else:
            row.update(
                fits=True, ms=(time.perf_counter() - t0) * 1000.0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            del out
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
