"""The morphology probes on the card: the port of scripts/mosaic_probe.py,
mosaic_probe2.py, mosaic_probe3.py, mosaic_probe4.py, mosaic_probe5.py and
mosaic_probe10.py's ``main()``s.

Each probe asks, of one TPU, how the filter's morphology primitive should
be built: the dtype and form of a shifted min/max/add pass (probes 1-4),
the type a tophat stages its pixels in (probe 5), and whether two
independent tophats gain from sharing one kernel (probe 10).  This module
asks the same of the card it runs on:

    python -m lane_tracker_tpu_torch.probes.mosaic [--reps N]

It needs CUDA (it raises without it) and prints one JSON row per probe row,
under the reference's names and fields:

* the 65 shift-chain rows (kernels/shift_chain.VARIANTS) on the probes'
  inputs at full size, (1104, 1280), K=64: ``ok`` from the kernel against
  its plain twin, ``us_per_pass`` (the chain's time over K, as the probes
  divide) and ``ms_k_passes`` from CUDA events; the rejected variant
  prints ``error``;
* probe 4's tophat rows, one per k (``lt_tophat``, uint8 staging), and
  probe 5's ``tophat_staged`` rows (bf16 and f32 staging) on
  ``default_rng(1)`` frames (32, 1100, 1080): ``exact`` against the plain
  tophat, ``ms_per_frame`` and ``ms`` (one call);
* probe 10's rows on the warped R and LAB-B of the four stills
  (assets/stills_720p.npz) cycled to 128 frames, through the port's own
  'fast' warp (1080x1100): the two ``tophat_ellipse`` calls (k=29 on R,
  k=55 on LAB-B) and ``dual_tophat``, ``exact`` against both the separate
  calls and the plain twins.

Probe 4's and probe 10's row-block choices (``b368``, ``full``, ``half``,
``dual_H/2``, ``dual_H/3``) are VMEM tilings of the TPU kernels with no
counterpart in the 32x32-tile kernels here, so those rows print
``"block": "n/a"``, once per k (probe 4) and once for the dual (probe 10).
``run(reps=0)`` launches every kernel once and times nothing, the form
chip_smoke.py drives and counts.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from lane_tracker_tpu_torch.device import entry_device
from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.kernels import shift_chain as sc
from lane_tracker_tpu_torch.timing import cuda_ms

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "assets"
TOPHAT_T = 32
DUAL_T = 128
TOPHAT_HW = (1100, 1080)
PROBE4_TOPHATS = (("tophat29", 29), ("tophat55", 55))
PROBE5 = (("tophat29_bf16", 29, torch.bfloat16),
          ("tophat55_bf16", 55, torch.bfloat16),
          ("tophat29_f32", 29, torch.float32))
DUAL_K = (29, 55)
NA = "n/a"


def compare(got, want) -> tuple:
    """(equal, max abs difference) of two tensors or tuples of them."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(float((g.double() - w.double()).abs().max()) for g, w in pairs)
    return all(torch.equal(g, w) for g, w in pairs), err


def chain_rows(device, reps: int = 0, h: int = sc.H, w: int = sc.W,
               k: int = sc.K, emit=None) -> list:
    """Probes 1-4's shift-chain rows."""
    rows = []
    for v in sc.VARIANTS:
        row = {"variant": v.name, "probe": v.probe}
        try:
            v.check()
        except ValueError as e:
            row["error"] = str(e)
        else:
            x = sc.make_input(v, h, w, device)
            row["kernel"] = ("shift_chain_2d" if v.body == "morph_chain8"
                             else "shift_chain")
            before = sum(sc.LAUNCHES.values())
            got = sc.shift_chain(x, v, k)
            row["launches"] = sum(sc.LAUNCHES.values()) - before
            row["ok"], row["max_abs_err"] = compare(
                got, sc.shift_chain_plain(x, v, k))
            if reps:
                ms = cuda_ms(lambda: sc.shift_chain(x, v, k), reps)
                row.update(us_per_pass=ms * 1e3 / k, ms_k_passes=ms,
                           plain_ms=cuda_ms(
                               lambda: sc.shift_chain_plain(x, v, k), 1))
        rows.append(row)
        if emit:
            emit(row)
    return rows


def probe_frames(t: int, device, hw=TOPHAT_HW) -> torch.Tensor:
    """Probes 4 and 5's input: ``default_rng(1)`` uint8 frames."""
    vals = np.random.default_rng(1).integers(0, 256, (t, *hw), np.uint8)
    return torch.from_numpy(vals).to(device)


def tophat_rows(device, reps: int = 0, t: int = TOPHAT_T, hw=TOPHAT_HW,
                emit=None) -> list:
    """Probe 4's tophat rows (uint8 staging, one per k) and probe 5's."""
    img = probe_frames(t, device, hw)
    cases = [(name, 4, kk, None) for name, kk in PROBE4_TOPHATS]
    cases += [(name, 5, kk, dt) for name, kk, dt in PROBE5]
    rows = []
    for name, probe, kk, dt in cases:
        def fn(kk=kk, dt=dt):
            return (fs.tophat_ellipse(img, kk) if dt is None
                    else fs.tophat_staged(img, kk, dt))
        row = {"variant": name, "probe": probe,
               "kernel": "tophat_ellipse" if dt is None else "tophat_staged",
               "k": kk, "staging": str(dt or torch.uint8).split(".")[-1]}
        if probe == 4:
            row["block"] = NA
        row["exact"], row["max_abs_err"] = compare(
            fn(), fs.tophat_ellipse_plain(img, kk))
        if reps:
            row["ms"] = cuda_ms(fn, reps)
            row["ms_per_frame"] = row["ms"] / t
            row["plain_ms"] = cuda_ms(
                lambda kk=kk: fs.tophat_ellipse_plain(img, kk), 1)
        rows.append(row)
        if emit:
            emit(row)
    return rows


def warped_channels(t: int, device) -> tuple:
    """Probe 10's input: the warped R and LAB-B of the four stills cycled
    to t frames, through the port's exact 'fast' warp."""
    from lane_tracker_tpu_torch.calib.io import load_calibration_npz
    from lane_tracker_tpu_torch.tracker.step import (
        TrackerParams,
        warp_channels,
    )

    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="fast", device=device)
    with np.load(ASSETS / "stills_720p.npz") as z:
        stills = z["frames"]
    frames = torch.from_numpy(stills[np.arange(t) % len(stills)]).to(device)
    return warp_channels(frames, params)


def dual_rows(device, reps: int = 0, t: int = DUAL_T, emit=None) -> list:
    """Probe 10's rows: the two tophats separately and in one kernel."""
    r, b = warped_channels(t, device)
    ka, kb = DUAL_K

    def separate():
        return fs.tophat_ellipse(r, ka), fs.tophat_ellipse(b, kb)

    def dual():
        return fs.dual_tophat(r, b, ka, kb)

    want = separate()
    got = dual()
    plain = fs.dual_tophat_plain(r, b, ka, kb)
    rows = [{"stage": "separate_29_55", "probe": 10,
             "kernel": "tophat_ellipse", "shape": list(r.shape)},
            {"stage": "dual", "probe": 10, "kernel": "dual_tophat",
             "block": NA}]
    rows[0]["exact"], rows[0]["max_abs_err"] = compare(want, plain)
    ok_sep, err_sep = compare(got, want)
    ok_plain, err_plain = compare(got, plain)
    rows[1]["exact"] = ok_sep and ok_plain
    rows[1]["max_abs_err"] = max(err_sep, err_plain)
    if reps:
        plain_ms = cuda_ms(lambda: fs.dual_tophat_plain(r, b, ka, kb), 1)
        for row, fn in zip(rows, (separate, dual)):
            row["ms"] = cuda_ms(fn, reps)
            row["ms_per_frame"] = row["ms"] / t
            row["plain_ms"] = plain_ms
    for row in rows:
        if emit:
            emit(row)
    return rows


def run(device="cuda", reps: int = 0, emit=None, h: int = sc.H,
        w: int = sc.W, k: int = sc.K, tophat_t: int = TOPHAT_T,
        tophat_hw=TOPHAT_HW, dual_t: int = DUAL_T) -> list:
    """Every probe row, in the probes' order; ``reps`` > 0 also times each
    row over that many calls.  The defaults are the probes' full sizes."""
    device = entry_device(device)
    return (chain_rows(device, reps, h, w, k, emit)
            + tophat_rows(device, reps, tophat_t, tophat_hw, emit)
            + dual_rows(device, reps, dual_t, emit))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10,
                    help="calls per timed row (CUDA events)")
    args = ap.parse_args(argv)
    entry_device("cuda")
    print(f"# {torch.cuda.get_device_name(0)}", flush=True)
    rows = run("cuda", args.reps,
               emit=lambda row: print(json.dumps(row), flush=True))
    bad = [r.get("variant", r.get("stage")) for r in rows
           if "error" not in r and not r.get("ok", r.get("exact"))]
    if bad:
        print(f"mismatches against the plain twins: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
