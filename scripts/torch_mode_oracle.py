#!/usr/bin/env python3
"""Write assets/mode_oracle.npz: the JAX package's 'turbo' and 'half'
results on chip_smoke.py's two 64-frame chunks, for its phase 15.

Runs the JAX package on the CPU (no accelerator needed):

    python3 scripts/torch_mode_oracle.py [--out assets/mode_oracle.npz]

The chunks are chip_smoke.py's: the four decoded stills of
assets/stills_720p.npz cycled to 64 frames ('stills'), and the same with
frames 0, 16, 32 and 48 black ('fail16').  Each runs through
``parallel.pipeline.chunk_process`` (demo1, halved by ``halve_config`` for
'half' as ``LaneTracker`` does; two_phase; a fresh state).  For each
pipeline P and chunk C the file holds ``P_C_valid`` (64,) bool and
``P_C_left`` / ``P_C_right`` (64, 3) float32 coefficients, in the
pipeline's own warped space ('half''s is 540x550), and ``P_C_n_attempts``
(64,) int32.  chip_smoke.py reads only this file: the card's machine has
no JAX.
"""

import argparse
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
T = 64
FAIL_EVERY = 16
PIPELINES = ("turbo", "half")


def chunks(stills):
    import numpy as np

    frames = stills[np.arange(T) % len(stills)]
    fail = frames.copy()
    fail[::FAIL_EVERY] = 0
    return {"stills": frames, f"fail{FAIL_EVERY}": fail}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "assets" / "mode_oracle.npz"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from lane_tracker_tpu.calib.io import load_calibration_npz
    from lane_tracker_tpu.parallel.pipeline import chunk_process
    from lane_tracker_tpu.tracker.config import PRESETS, halve_config
    from lane_tracker_tpu.tracker.step import (
        TrackerParams,
        make_initial_state,
    )

    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")
    with np.load(REPO / "assets" / "stills_720p.npz") as z:
        stills = z["frames"]
    out = {}
    for pipeline in PIPELINES:
        params = TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph, pipeline=pipeline)
        cfg = PRESETS["demo1"]
        if pipeline == "half":
            cfg = halve_config(cfg)
        run = jax.jit(lambda s, f, p, c=cfg: chunk_process(
            s, f, p, c, False, second_attempt="two_phase"))
        for tag, frames in chunks(stills).items():
            t0 = time.perf_counter()
            _, o = run(make_initial_state(cfg, params.warped_size), frames,
                       params)
            key = f"{pipeline}_{tag}"
            out[f"{key}_valid"] = np.asarray(o.valid)
            out[f"{key}_left"] = np.asarray(o.left_coeffs, np.float32)
            out[f"{key}_right"] = np.asarray(o.right_coeffs, np.float32)
            out[f"{key}_n_attempts"] = np.asarray(o.n_attempts, np.int32)
            print(f"{key}: valid {int(out[f'{key}_valid'].sum())}/{T}, "
                  f"second attempts {int((out[f'{key}_n_attempts'] > 1).sum())}"
                  f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
