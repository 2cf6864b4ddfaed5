#!/usr/bin/env python3
"""This tree's end-to-end timings against an earlier tree's, in turns, on
one CUDA card.

Each turn is one process that imports ``lane_tracker_tpu_torch`` from one
tree and times, by CUDA events (``--pairs`` pairs of turns, the side that
runs first alternating: parent, this tree, this tree, parent, ...):

* ``LaneTracker.process`` ('fast', demo1, one frame a call): the median
  ms a frame over 16 frames after 4 warm-up frames;
* ``chunk_process`` (demo1, 'corridor', two_phase, overlay on) on the 64
  stills (assets/stills_720p.npz cycled): the median ms a chunk over 5
  chunks, state carried, after one warm-up chunk;
* ``StreamFleet.step`` (demo1 'fast', S=8 streams x T=32 frames, overlay
  on, two_phase), stream s the stills cycled from offset s: the median ms
  a step over 3 steps after a warm-up step.

One JSON row a turn: the tree, the three medians, the card's name and
power limit.  The trees' kernels are built from their own sources (into
each tree's build/).

Usage:
    git archive <commit> lane_tracker_tpu_torch assets | tar -x -C build/parent
    python3 scripts/torch_parent_ab.py --parent build/parent
"""

import argparse
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

MEASURE = r"""
import json, subprocess, sys
sys.path.insert(0, {tree!r})
import numpy as np
import torch
import lane_tracker_tpu_torch as lt
from lane_tracker_tpu_torch.kernels.build import build
from lane_tracker_tpu_torch.parallel import StreamFleet, chunk_process
from lane_tracker_tpu_torch.tracker.step import (TrackerParams,
                                                  make_initial_state)

assets = {assets!r}
build()
cam, warp = lt.load_calibration_npz(assets + "/calibration.npz")
cfg = lt.PRESETS["demo1"]
with np.load(assets + "/stills_720p.npz") as z:
    stills = z["frames"]


def params(pipeline):
    return TrackerParams.build(cam.cam_matrix, cam.dist_coeffs, warp.M,
                               warp.Minv, warp.image_width_height,
                               warp.warped_width_height, warp.mppv,
                               warp.mpph, pipeline=pipeline)


def timed(fn, n):
    ms = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


tracker = lt.LaneTracker(warp.image_width_height, warp.warped_width_height,
                         cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
                         (warp.mppv, warp.mpph), validity=cfg.validity)
kw = dict(mask_noise=True, no_success_limit=50, bandwidth=30)
frames8 = stills[np.arange(8) % 4]
for f in frames8[:4]:
    tracker.process(f, **kw)
it = iter(range(10 ** 6))
process_ms = timed(lambda: tracker.process(frames8[next(it) % 8], **kw), 16)

gp = params("corridor")
chunk = torch.from_numpy(stills[np.arange(64) % 4]).cuda()
state = [chunk_process(make_initial_state(cfg, gp.warped_size, "cuda"),
                       chunk, gp, cfg, second_attempt="two_phase")[0]]


def one_chunk():
    state[0] = chunk_process(state[0], chunk, gp, cfg,
                             second_attempt="two_phase")[0]


chunk_ms = timed(one_chunk, 5)

fleet = StreamFleet(params("fast"), cfg, 8, with_overlay=True,
                    second_attempt="two_phase")
fr = torch.from_numpy(np.stack([stills[(s + np.arange(32)) % 4]
                                for s in range(8)])).cuda()
fleet.step(fr)
fleet_ms = timed(lambda: fleet.step(fr), 3)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip().splitlines()[0]
print(json.dumps(dict(process_ms=process_ms, chunk_ms=chunk_ms,
                      fleet_step_ms=fleet_ms, card=card)))
"""


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding an earlier commit's "
                         "lane_tracker_tpu_torch")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    trees = {"parent": str(pathlib.Path(args.parent).resolve()),
             "this": str(REPO)}
    order = [("parent", "this"), ("this", "parent")] * args.pairs
    for name in [n for pair in order[:args.pairs] for n in pair]:
        res = subprocess.run(
            [sys.executable, "-c", MEASURE.format(
                tree=trees[name], assets=str(REPO / "assets"))],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
