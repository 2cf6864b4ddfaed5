#!/usr/bin/env python3
"""Prove on one NVIDIA GPU that the PyTorch port runs its main path.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises at the first failure; nothing is skipped):

1. Device: the card's name and power limit.
2. Build: nvcc builds the port's CUDA kernels from csrc/.
3. Frames: the four decoded stills (assets/stills_720p.npz).
4. Kernel parity: the three filter-stage kernels against their plain
   PyTorch twins on the card, on the corridor channels of the slice's 64
   frames, the inputs the main path gives them; every output, prefixes
   included, must match exactly.
5. Slice: ``chunk_process`` (demo1, 'corridor', two_phase, overlay on) on
   64 frames from a fresh state; every kernel must have launched, the
   corridor certificate must hold on all frames, the validity trace must
   equal assets/bench_oracle.npz and the curves must be within 0.5 px RMSE
   of its coefficients.  The CPU path on the first 8 frames must give the
   same integer decisions.
6. Timing (printed, not gated): chunk frames/s and per-kernel times
   against the plain twins, with CUDA events.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

import copy
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
T_SLICE = 64
T_CPU = 8
N_TIMED_CHUNKS = 5
RMSE_LIMIT_PX = 0.5
DECISIONS = ("valid", "detected", "search_mode", "n_points_left",
             "n_points_right", "corridor_ok", "render_mode", "n_attempts")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mismatches(a, b):
    """(number of differing elements, max abs difference) of two tensors."""
    d = (a.long() - b.long()).abs()
    return int((d != 0).sum()), int(d.max())


def curve_rmse_px(mine, ref, H):
    import numpy as np

    yy = np.arange(H, dtype=float)
    return float(np.sqrt(np.mean(
        (np.polyval(np.asarray(mine, float), yy)
         - np.polyval(np.asarray(ref, float), yy)) ** 2)))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "lane_tracker_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no lane_tracker_tpu_torch package beside "
              f"{__file__}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lane_tracker_tpu_torch.calib.io import load_calibration_npz
    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.kernels.build import build
    from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
    from lane_tracker_tpu_torch.tracker.config import PRESETS
    from lane_tracker_tpu_torch.tracker.step import (
        TrackerParams,
        make_initial_state,
        warp_channels,
    )

    # ---- 1. Device ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"{kind}, power limit not readable")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s); device 0: {kind}")
    print(card)

    # ---- 2. Build ----
    t0 = time.perf_counter()
    lib_path, nvcc_s, log = build()
    print(f"[build] {lib_path.name}: nvcc {nvcc_s:.1f} s, "
          f"build() {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas info" in line:
            print(f"[build] {line.strip()}")

    # ---- 3. Frames ----
    with np.load(REPO / "assets" / "stills_720p.npz") as z:
        stills = z["frames"]
    with np.load(REPO / "assets" / "bench_oracle.npz") as z:
        oracle = {k: z[k] for k in ("valid", "left", "right")}
    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor")
    gparams = copy.deepcopy(params).cuda()
    cfg = PRESETS["demo1"]
    f = cfg.filter
    chunk = torch.from_numpy(stills[np.arange(T_SLICE) % len(stills)])
    gchunk = chunk.cuda()
    print(f"[frames] {tuple(chunk.shape)} uint8 from stills_720p.npz; "
          f"corridor raw rows {params.raw_roi}, compute columns "
          f"{params.col_comp}, decisions {params.col_roi}")

    # ---- 4. Kernel parity ----
    r, b = warp_channels(gchunk, gparams)
    errs = {}
    r_feat = fs.tophat_ellipse(r, f.tophat_r)
    errs["tophat_ellipse"] = [mismatches(r_feat,
                                         fs.tophat_ellipse_plain(r, f.tophat_r))]
    riders = [(r_feat, f.ksize_r, f.C_r, -1),
              (b, f.ksize_noise, f.C_noise, f.noise_thresh)]
    outs = fs.tophat_riders(b, f.tophat_b, riders)
    plain = fs.tophat_riders_plain(b, f.tophat_b, riders)
    errs["tophat_riders"] = [mismatches(g, w) for g, w in zip(outs, plain)]
    b_feat, r_th, keep = outs
    got = fs.thr_merge_open(r_th, b_feat, f.ksize_b, f.C_b, keep,
                            open_k=f.open_k)
    want = fs.thr_merge_open_plain(r_th, b_feat, f.ksize_b, f.C_b, keep,
                                   open_k=f.open_k)
    errs["thr_merge_open"] = [mismatches(got[0], want[0]),
                              mismatches(got[1].packed, want[1].packed)]
    torch.cuda.synchronize()
    for name, pairs in errs.items():
        print(f"[parity] {name} at {tuple(r.shape)}: mismatches "
              f"{[n for n, _ in pairs]} (outputs in order), max abs "
              f"{max(m for _, m in pairs)}")
        check(all(n == 0 for n, _ in pairs), f"{name} disagrees with its "
              "plain twin")
    max_err = {name: max(m for _, m in pairs) for name, pairs in errs.items()}

    # ---- 5. Slice ----
    fs.reset_launches()
    state0 = make_initial_state(cfg, gparams.warped_size, "cuda")
    t0 = time.perf_counter()
    state, out = chunk_process(state0, gchunk, gparams, cfg, with_overlay=True,
                               second_attempt="two_phase")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(fs.LAUNCHES)
    print(f"[slice] chunk_process T={T_SLICE} on the card: {first_s:.2f} s "
          f"(first call); launches {launches}")
    check(all(launches[name] > 0 for name in fs.REPLACES),
          "a kernel of the path did not launch")
    check(tuple(out.overlay.shape) == (T_SLICE, 720, 1280, 3)
          and out.overlay.dtype == torch.uint8, "overlay shape/dtype")
    coeffs = torch.cat([out.left_coeffs, out.right_coeffs]).cpu().numpy()
    check(np.isfinite(coeffs).all(), "non-finite coefficients")
    ok = out.corridor_ok.cpu().numpy()
    print(f"[slice] corridor_ok {int(ok.sum())}/{T_SLICE}")
    check(ok.all(), "corridor certificate failed")
    valid = out.valid.cpu().numpy()
    n_trace_diff = int((valid != oracle["valid"][:T_SLICE]).sum())
    print(f"[slice] valid {int(valid.sum())}/{T_SLICE}; frames differing "
          f"from bench_oracle.npz: {n_trace_diff}")
    check(n_trace_diff == 0, "validity trace differs from the oracle")
    H = gparams.warped_size[1]
    rs = [curve_rmse_px(mine, ref, H)
          for t in range(T_SLICE) if valid[t] and oracle["valid"][t]
          for mine, ref in ((out.left_coeffs[t].cpu().numpy(),
                             oracle["left"][t]),
                            (out.right_coeffs[t].cpu().numpy(),
                             oracle["right"][t]))]
    rmse_max = max(rs)
    print(f"[slice] rmse_px_max vs oracle {rmse_max} (mean "
          f"{float(np.mean(rs))}, limit {RMSE_LIMIT_PX})")
    check(rmse_max <= RMSE_LIMIT_PX, "curves too far from the oracle")

    t0 = time.perf_counter()
    _, cpu = chunk_process(make_initial_state(cfg, params.warped_size),
                           chunk[:T_CPU], params, cfg)
    print(f"[slice] CPU path T={T_CPU}: {time.perf_counter() - t0:.1f} s")
    for name in DECISIONS:
        n, m = mismatches(getattr(out, name)[:T_CPU].cpu(),
                          getattr(cpu, name))
        print(f"[slice] GPU vs CPU {name}: {n} differ")
        check(n == 0, f"GPU and CPU disagree on {name}")
    dc = (torch.cat([out.left_coeffs, out.right_coeffs], 1)[:T_CPU].cpu()
          - torch.cat([cpu.left_coeffs, cpu.right_coeffs], 1)).abs().max()
    n_ov, m_ov = mismatches(out.overlay[:T_CPU].cpu(), cpu.overlay)
    print(f"[slice] GPU vs CPU coefficients max abs diff {float(dc)}; "
          f"overlay values differing {n_ov} (max {m_ov})")

    # ---- 6. Timing (not gated) ----
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(N_TIMED_CHUNKS):
        state, out = chunk_process(state, gchunk, gparams, cfg)
    end.record()
    torch.cuda.synchronize()
    chunk_ms = start.elapsed_time(end) / N_TIMED_CHUNKS
    print(f"[timing] chunk_process T={T_SLICE}: {chunk_ms:.2f} ms/chunk, "
          f"{T_SLICE * 1000.0 / chunk_ms:.1f} frames/s over "
          f"{N_TIMED_CHUNKS} chunks, state carried ({card})")
    check(bool(out.valid.all()), "timed chunks lost tracking")

    calls = {
        "tophat_ellipse": (lambda: fs.tophat_ellipse(r, f.tophat_r),
                           lambda: fs.tophat_ellipse_plain(r, f.tophat_r)),
        "tophat_riders": (
            lambda: fs.tophat_riders(b, f.tophat_b, riders),
            lambda: fs.tophat_riders_plain(b, f.tophat_b, riders)),
        "thr_merge_open": (
            lambda: fs.thr_merge_open(r_th, b_feat, f.ksize_b, f.C_b, keep,
                                      open_k=f.open_k),
            lambda: fs.thr_merge_open_plain(r_th, b_feat, f.ksize_b, f.C_b,
                                            keep, open_k=f.open_k)),
    }
    kernels = []
    for name, (kernel, twin) in calls.items():
        # plain, kernel, kernel, plain: the means of each pair.
        p1 = cuda_ms(twin, 3)
        k1 = cuda_ms(kernel, 10)
        k2 = cuda_ms(kernel, 10)
        p2 = cuda_ms(twin, 3)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"[timing] {name} at {tuple(r.shape)}: kernel {ms:.3f} ms, "
              f"plain twin {plain_ms:.3f} ms ({card})")
        kernels.append({
            "name": name, "route": "cuda", "source": fs.SOURCE,
            "replaces": fs.REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
        })

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
