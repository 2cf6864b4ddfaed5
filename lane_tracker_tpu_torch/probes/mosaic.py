"""The Mosaic probes on the card: the port of scripts/mosaic_probe.py,
mosaic_probe2.py to mosaic_probe6.py, mosaic_probe10.py and
mosaic_probe11.py's ``main()``s.

Each probe asks, of one TPU, how a filter or warp kernel should be built:
the dtype and form of a shifted min/max/add pass (probes 1-4), the type a
tophat stages its pixels in (probe 5), whether matrix products run beside
vector sweeps inside one kernel (probe 6), whether two independent tophats
gain from sharing one kernel (probe 10), and what a dynamic gather inside
one tile costs (probe 11).  This module asks the same of the card it runs
on:

    python -m lane_tracker_tpu_torch.probes.mosaic [--reps N]

It needs CUDA (it raises without it) and prints one JSON row per probe row,
under the reference's names and fields:

* the 65 shift-chain rows (kernels/shift_chain.VARIANTS) on the probes'
  inputs at full size, (1104, 1280), K=64: ``ok`` from the kernel against
  its plain twin, ``us_per_pass`` (the chain's time over K, as the probes
  divide) and ``ms_k_passes``, the device time per call with the calls
  queued behind a spin kernel (``timing.queued_ms``: a chain of a few
  microseconds is otherwise paced by the host's launch), and
  ``events_ms_k_passes``, the same calls timed by CUDA events alone
  (``timing.cuda_ms``, as these rows were timed before the spin kernel);
  the rejected variant prints ``error``;
* probe 4's tophat rows, one per k (``lt_tophat``: the production
  kernel, one launch over one widened plane of window min/max, u8 lanes),
  and probe 5's ``tophat_staged`` rows (the same tile, one launch, its
  planes in bf16 and f32 lanes) on ``default_rng(1)`` frames (32, 1100,
  1080): ``exact`` against the plain tophat, ``ms_per_frame`` and ``ms``
  (one call);
* probe 10's rows on the warped R and LAB-B of the four stills
  (assets/stills_720p.npz) cycled to 128 frames, through the port's own
  'fast' warp (1080x1100): the two ``tophat_ellipse`` calls (k=29 on R,
  k=55 on LAB-B) and ``dual_tophat``, ``exact`` against both the separate
  calls and the plain twins;
* probe 6's rows, one per kind (``sweeps``, ``dots``, ``both``), through
  ``sweep_dots`` (kernels/sweep_dots.py) on ``default_rng(0)`` frames
  (32, 600, 1280) bf16: ``ok`` (swept equal to the twin's; out equal to
  it for ``sweeps``, within ``sweep_dots.RTOL`` otherwise), ``max_rel_err``,
  ``launches`` and ``ms_per_frame``; the ``dots`` row also gives
  ``library_ms``, one batched ``torch.matmul`` of the (T*3, 368, 1152) row
  blocks by tri and its sum: the products' library time, not a port;
* probe 11's rows, one per op, through ``tile_gather``
  (kernels/tile_gather.py) on the probe's ``default_rng(0)`` (128, 1280)
  int32 inputs: ``ok`` (both chain lengths, 16 and 64, equal to the twin),
  ``t_lo_us`` and ``t_hi_us`` (the device time per call at each length,
  the calls queued behind a spin kernel so that the card runs them back to
  back, ``timing.queued_ms``: a call of a few microseconds is otherwise
  paced by the host's launch), ``ns_per_vreg_stmt`` by
  the reference's formula (t(64) - t(16)) / 48 / 160 and ``ns_per_rep`` =
  (t(64) - t(16)) / 48.  On the TPU the 160 (8, 128) tiles of a rep run one
  after another, so the reference divides by them; on the card all 160 run
  at once, one CTA each, so ``ns_per_rep`` is the figure that means
  something here.

Probe 10's ``separate_29_55`` row is two calls of ``lt_tophat``, one
launch each, against ``dual_tophat``'s one launch over both problems'
tiles.  Probe 4's and probe 10's row-block choices (``b368``,
``full``, ``half``, ``dual_H/2``, ``dual_H/3``) are VMEM tilings of the TPU
kernels with no counterpart in the kernels here, so those rows print
``"block": "n/a"``, once per k (probe 4) and once for the dual (probe 10).
``run(reps=0)`` launches every kernel once per row and times nothing
(``tile_gather`` once per chain length), the form chip_smoke.py drives and
counts.
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
from lane_tracker_tpu_torch.kernels import sweep_dots as sd
from lane_tracker_tpu_torch.kernels import tile_gather as tg
from lane_tracker_tpu_torch.timing import cuda_ms, queued_ms

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
OVERLAP_SHAPE = (sd.T, sd.ROWS, sd.COLS)
OVERLAP_DIMS = (sd.BLOCK, sd.KP, sd.NP)
TILES = (tg.H // tg.TILE_H) * (tg.W // tg.TILE_W)  # 160 tiles a rep


def row_name(row) -> str:
    """A row's name: its variant, stage, probe 6 kind or probe 11 op."""
    for key in ("variant", "stage", "kind", "probe"):
        if key in row:
            return row[key]
    raise KeyError(row)


def row_ok(row) -> bool:
    return bool(row.get("ok", row.get("exact")))


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
                ms = queued_ms(lambda: sc.shift_chain(x, v, k), reps)
                row.update(us_per_pass=ms * 1e3 / k, ms_k_passes=ms,
                           events_ms_k_passes=cuda_ms(
                               lambda: sc.shift_chain(x, v, k), reps),
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


def dots_library(x: torch.Tensor, tri: torch.Tensor, block: int = sd.BLOCK,
                 col0: int = sd.COL0):
    """Probe 6's products as one library call (a yardstick, not a port):
    a function that runs one batched ``torch.matmul`` of the (T*3, block,
    KP) row blocks of x by tri (bf16 out) and sums each frame's in f32."""
    kp = tri.shape[0]
    t = x.shape[0]
    blocks = torch.stack(
        [x[:, sd.BLOCK_STEP * j:sd.BLOCK_STEP * j + block, col0:col0 + kp]
         for j in range(sd.N_BLOCKS)], 1).reshape(-1, block, kp)
    return lambda: torch.matmul(blocks, tri).view(t, -1).sum(
        1, dtype=torch.float32)


def overlap_rows(device="cuda", reps: int = 0, shape=OVERLAP_SHAPE,
                 dims=OVERLAP_DIMS, emit=None) -> list:
    """Probe 6's rows: sweeps, dots and both, through ``sweep_dots``."""
    device = entry_device(device)
    t, h, w = shape
    block, kp, n = dims
    x, tri = sd.make_inputs(t, h, w, kp, n, device)
    rows = []
    for kind in sd.KINDS:
        def fn(kind=kind):
            return sd.sweep_dots(x, tri, kind, block=block)

        def twin(kind=kind):
            return sd.sweep_dots_plain(x, tri, kind, block=block)

        row = {"probe": 6, "kind": kind, "kernel": "sweep_dots"}
        before = sd.LAUNCHES["sweep_dots"]
        out, swept = fn()
        row["launches"] = sd.LAUNCHES["sweep_dots"] - before
        want, want_swept = twin()
        row["swept_mismatches"] = int((swept != want_swept).sum())
        diff = (out.double() - want.double()).abs()
        row["max_abs_err"] = float(diff.max())
        row["max_rel_err"] = float((diff / want.double().abs()).max())
        row["ok"] = row["swept_mismatches"] == 0 and (
            row["max_abs_err"] == 0 if kind == "sweeps"
            else row["max_rel_err"] <= sd.RTOL)
        if reps:
            row["ms"] = cuda_ms(fn, reps)
            row["ms_per_frame"] = row["ms"] / t
            row["plain_ms"] = cuda_ms(twin, 1)
            if kind == "dots":
                row["library_ms"] = cuda_ms(dots_library(x, tri, block), reps)
        rows.append(row)
        if emit:
            emit(row)
    return rows


def gather_rows(device="cuda", reps: int = 0, emit=None) -> list:
    """Probe 11's rows: each op at chain lengths 16 and 64, through
    ``tile_gather``."""
    device = entry_device(device)
    src, li, si = tg.make_inputs(device)
    rows = []
    for op in tg.OPS:
        def fn(n, op=op):
            return tg.tile_gather(src, li, si, op, n)

        def twin(n, op=op):
            return tg.tile_gather_plain(src, li, si, op, n)

        row = {"probe": op, "kernel": "tile_gather"}
        before = tg.LAUNCHES["tile_gather"]
        errs = [compare(fn(n), twin(n)) for n in tg.REPS]
        row["launches"] = tg.LAUNCHES["tile_gather"] - before
        row["ok"] = all(ok for ok, _ in errs)
        row["max_abs_err"] = max(err for _, err in errs)
        if reps:
            lo, hi = (queued_ms(lambda n=n: fn(n), reps) for n in tg.REPS)
            per_rep_ns = (hi - lo) * 1e6 / (tg.REPS[1] - tg.REPS[0])
            row.update(ns_per_vreg_stmt=per_rep_ns / TILES,
                       ns_per_rep=per_rep_ns, t_lo_us=lo * 1e3,
                       t_hi_us=hi * 1e3, ms=lo + hi,
                       plain_ms=sum(cuda_ms(lambda n=n: twin(n), 1)
                                    for n in tg.REPS))
        rows.append(row)
        if emit:
            emit(row)
    return rows


def run(device="cuda", reps: int = 0, emit=None, h: int = sc.H,
        w: int = sc.W, k: int = sc.K, tophat_t: int = TOPHAT_T,
        tophat_hw=TOPHAT_HW, dual_t: int = DUAL_T,
        overlap_shape=OVERLAP_SHAPE, overlap_dims=OVERLAP_DIMS) -> list:
    """Every probe row, in the probes' order; ``reps`` > 0 also times each
    row over that many calls.  The defaults are the probes' full sizes."""
    device = entry_device(device)
    return (chain_rows(device, reps, h, w, k, emit)
            + tophat_rows(device, reps, tophat_t, tophat_hw, emit)
            + overlap_rows(device, reps, overlap_shape, overlap_dims, emit)
            + dual_rows(device, reps, dual_t, emit)
            + gather_rows(device, reps, emit))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10,
                    help="calls per timed row (CUDA events)")
    args = ap.parse_args(argv)
    entry_device("cuda")
    print(f"# {torch.cuda.get_device_name(0)}", flush=True)
    rows = run("cuda", args.reps,
               emit=lambda row: print(json.dumps(row), flush=True))
    bad = [row_name(r) for r in rows if "error" not in r and not row_ok(r)]
    if bad:
        print(f"mismatches against the plain twins: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
