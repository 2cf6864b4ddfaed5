#!/usr/bin/env python3
"""Prove on one NVIDIA GPU that the PyTorch port runs its main path.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises at the first failure; nothing is skipped):

1. Device: the card's name and power limit.
2. Build: nvcc builds the port's CUDA kernels from csrc/.
3. Frames: the four decoded stills (assets/stills_720p.npz), cycled to 64
   frames; the fail16 chunk is the same with every 16th frame black.
4. Kernel parity: the six filter-stage kernels against their plain
   PyTorch twins on the card, on the corridor channels of the slice's 64
   frames, the inputs the main path gives them (the second attempt's at
   its k=15 / k=35, C=-5; the standalone threshold at k=65); every output,
   prefixes included, must match exactly.
5. Slice: ``chunk_process`` (demo1, 'corridor', two_phase, overlay on) on
   the 64 stills from a fresh state; the attempt-1 kernels must have
   launched and the second attempt's not, the corridor certificate must
   hold on all frames, the validity trace must equal
   assets/bench_oracle.npz and the curves must be within 0.5 px RMSE of
   its coefficients.  The CPU path on the first 8 frames must give the
   same integer decisions.
6. fail16 slice: the same on the fail16 chunk, which takes two_phase's
   fallback: two adaptive_mean launches and one merge_open; the trace must
   equal assets/bench_oracle_fail16.npz, n_attempts is 2 exactly where
   attempt 1 failed, 'hoist' (the filter once per chunk: 2 and 1 launches)
   and 'cond' (once per failing frame: 2 and 1 launches each) give
   two_phase's outputs, and the CPU path on the first 8 frames gives the
   same decisions.  Where the corridor certificate fails, the phase reruns
   in 'fast' (bench.py's rule), says so, and gates that run.
7. Filter route: ``filter_stage`` with ksize_b=65 launches the standalone
   threshold and merge_open and equals its plain chain.
8. Timing (printed, not gated): frames/s of the stills and the fail16
   chunks in each second-attempt mode, in turns, with state carried;
   per-kernel times against the plain twins with CUDA events; and a
   profile of one fail16 chunk per mode read through its ``lt.*`` ranges.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

import copy
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys
import time
from unittest import mock

REPO = pathlib.Path(__file__).resolve().parent
T_SLICE = 64
T_CPU = 8
FAIL_EVERY = 16
N_TIMED_CHUNKS = 5
RMSE_LIMIT_PX = 0.5
DECISIONS = ("valid", "detected", "search_mode", "n_points_left",
             "n_points_right", "corridor_ok", "render_mode", "n_attempts",
             "a1_valid")
ATTEMPT1 = ("tophat_ellipse", "tophat_riders", "thr_merge_open")
SECOND_ATTEMPT_LAUNCHES = {"adaptive_mean": 2, "merge_open": 1}
TIMED_MODES = ("two_phase", "cond", "hoist")


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


def gate_oracle(tag, out, oracle, H):
    """bench.py's quality gate: the validity trace equals the oracle's and
    the curves are within RMSE_LIMIT_PX of its coefficients on frames
    valid in both."""
    import numpy as np

    T = out.valid.shape[0]
    valid = out.valid.cpu().numpy()
    n_trace_diff = int((valid != oracle["valid"][:T]).sum())
    print(f"[{tag}] valid {int(valid.sum())}/{T}; invalid frames "
          f"{np.flatnonzero(~valid).tolist()}; frames differing from the "
          f"oracle: {n_trace_diff}")
    check(n_trace_diff == 0, f"{tag}: validity trace differs from the oracle")
    rs = [curve_rmse_px(mine, ref, H)
          for t in range(T) if valid[t] and oracle["valid"][t]
          for mine, ref in ((out.left_coeffs[t].cpu().numpy(),
                             oracle["left"][t]),
                            (out.right_coeffs[t].cpu().numpy(),
                             oracle["right"][t]))]
    rmse_max = max(rs)
    print(f"[{tag}] rmse_px_max vs oracle {rmse_max} (mean "
          f"{float(np.mean(rs))}, limit {RMSE_LIMIT_PX})")
    check(rmse_max <= RMSE_LIMIT_PX, f"{tag}: curves too far from the oracle")


def compare_cpu(tag, out, cpu):
    """The card's first T_CPU frames against the CPU path's."""
    import torch

    for name in DECISIONS:
        n, _ = mismatches(getattr(out, name)[:T_CPU].cpu(), getattr(cpu, name))
        print(f"[{tag}] GPU vs CPU {name}: {n} differ")
        check(n == 0, f"{tag}: GPU and CPU disagree on {name}")
    dc = (torch.cat([out.left_coeffs, out.right_coeffs], 1)[:T_CPU].cpu()
          - torch.cat([cpu.left_coeffs, cpu.right_coeffs], 1)).abs().max()
    n_ov, m_ov = mismatches(out.overlay[:T_CPU].cpu(), cpu.overlay)
    print(f"[{tag}] GPU vs CPU coefficients max abs diff {float(dc)}; "
          f"overlay values differing {n_ov} (max {m_ov})")


def same_outputs(a, b):
    """Decisions, coefficients and overlays of two StepOutputs agree
    exactly: (field, differing values) of each that does not."""
    names = DECISIONS + ("left_coeffs", "right_coeffs", "overlay")
    return [(n, mismatches(getattr(a, n), getattr(b, n))[0]) for n in names
            if not bool((getattr(a, n) == getattr(b, n)).all())]


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
    from torch.profiler import ProfilerActivity, profile

    from lane_tracker_tpu_torch.calib.io import load_calibration_npz
    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.kernels.build import build
    from lane_tracker_tpu_torch.ops.filters import filter_stage
    from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
    from lane_tracker_tpu_torch.tracker.config import PRESETS, SECOND_ATTEMPT
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
    oracles = {}
    for name in ("bench_oracle", f"bench_oracle_fail{FAIL_EVERY}"):
        with np.load(REPO / "assets" / f"{name}.npz") as z:
            oracles[name] = {k: z[k] for k in ("valid", "left", "right")}
    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")

    def build_params(pipeline):
        return TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph, pipeline=pipeline)

    params = build_params("corridor")
    gparams = copy.deepcopy(params).cuda()
    cfg = PRESETS["demo1"]
    f = cfg.filter
    f2 = SECOND_ATTEMPT.filter
    H = gparams.warped_size[1]

    def fresh(device):
        return make_initial_state(cfg, params.warped_size, device)

    chunk = torch.from_numpy(stills[np.arange(T_SLICE) % len(stills)])
    gchunk = chunk.cuda()
    fail_chunk = chunk.clone()
    fail_chunk[::FAIL_EVERY] = 0
    gfail = fail_chunk.cuda()
    print(f"[frames] {tuple(chunk.shape)} uint8 from stills_720p.npz; "
          f"fail{FAIL_EVERY}: frames {list(range(0, T_SLICE, FAIL_EVERY))} "
          f"black; corridor raw rows {params.raw_roi}, compute columns "
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
    am_args = [(r, f2.ksize_r, -f2.C_r), (b, f2.ksize_b, -f2.C_b)]
    r_am, b_am = (fs.adaptive_mean(*a) for a in am_args)
    errs["adaptive_mean"] = [mismatches(g, fs.adaptive_mean_plain(*a))
                             for g, a in zip((r_am, b_am), am_args)]
    errs["merge_open"] = []
    for k in (None, keep):
        got = fs.merge_open(r_am, b_am, k, open_k=f2.open_k)
        want = fs.merge_open_plain(r_am, b_am, k, open_k=f2.open_k)
        errs["merge_open"] += [mismatches(got[0], want[0]),
                               mismatches(got[1].packed, want[1].packed)]
    bt_args = [(b_feat, 65, f.C_b, -1),
               (b, 65, f.C_noise, f.noise_thresh)]
    errs["bilateral_threshold"] = [
        mismatches(fs.bilateral_threshold(*a),
                   fs.bilateral_threshold_plain(*a))
        for a in bt_args]
    torch.cuda.synchronize()
    for name, pairs in errs.items():
        print(f"[parity] {name} at {tuple(r.shape)}: mismatches "
              f"{[n for n, _ in pairs]} (outputs in order), max abs "
              f"{max(m for _, m in pairs)}")
        check(all(n == 0 for n, _ in pairs), f"{name} disagrees with its "
              "plain twin")
    max_err = {name: max(m for _, m in pairs) for name, pairs in errs.items()}
    launches = {}

    # ---- 5. Slice ----
    fs.reset_launches()
    t0 = time.perf_counter()
    _, out = chunk_process(fresh("cuda"), gchunk, gparams, cfg,
                           with_overlay=True, second_attempt="two_phase")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    slice_launches = dict(fs.LAUNCHES)
    print(f"[slice] chunk_process T={T_SLICE} on the card: {first_s:.2f} s "
          f"(first call, {card}); launches {slice_launches}")
    check(all(slice_launches[name] > 0 for name in ATTEMPT1),
          "a kernel of the path did not launch")
    check(all(slice_launches[name] == 0 for name in SECOND_ATTEMPT_LAUNCHES),
          "the second attempt ran on the stills")
    launches.update({name: slice_launches[name] for name in ATTEMPT1})
    check(tuple(out.overlay.shape) == (T_SLICE, 720, 1280, 3)
          and out.overlay.dtype == torch.uint8, "overlay shape/dtype")
    coeffs = torch.cat([out.left_coeffs, out.right_coeffs]).cpu().numpy()
    check(np.isfinite(coeffs).all(), "non-finite coefficients")
    ok = out.corridor_ok.cpu().numpy()
    print(f"[slice] corridor_ok {int(ok.sum())}/{T_SLICE}")
    check(ok.all(), "corridor certificate failed")
    gate_oracle("slice", out, oracles["bench_oracle"], H)

    t0 = time.perf_counter()
    _, cpu = chunk_process(fresh("cpu"),
                           chunk[:T_CPU], params, cfg,
                           second_attempt="two_phase")
    print(f"[slice] CPU path T={T_CPU}: {time.perf_counter() - t0:.1f} s")
    compare_cpu("slice", out, cpu)

    # ---- 6. fail16 slice ----
    tag = f"fail{FAIL_EVERY}"
    fparams, fcpu_params = gparams, params
    fs.reset_launches()
    _, fout = chunk_process(fresh("cuda"), gfail,
                            fparams, cfg, second_attempt="two_phase")
    torch.cuda.synchronize()
    fail_launches = dict(fs.LAUNCHES)
    print(f"[{tag}] chunk_process T={T_SLICE}, two_phase, fresh state; "
          f"launches {fail_launches}")
    check(all(fail_launches[name] > 0 for name in ATTEMPT1),
          f"{tag}: an attempt-1 kernel did not launch")
    check(all(fail_launches[name] == n
              for name, n in SECOND_ATTEMPT_LAUNCHES.items()),
          f"{tag}: the fallback did not launch the second attempt's kernels "
          f"{SECOND_ATTEMPT_LAUNCHES}")
    launches.update({name: fail_launches[name]
                     for name in SECOND_ATTEMPT_LAUNCHES})
    fok = fout.corridor_ok.cpu().numpy()
    print(f"[{tag}] corridor_ok {int(fok.sum())}/{T_SLICE}")
    if not fok.all():
        print(f"[{tag}] corridor certificate failed on "
              f"{int((~fok).sum())} frames; rerunning in the full-width "
              "'fast' pipeline (bench.py's rule) and gating that run")
        fcpu_params = build_params("fast")
        fparams = copy.deepcopy(fcpu_params).cuda()
        _, fout = chunk_process(fresh("cuda"), gfail,
                                fparams, cfg, second_attempt="two_phase")
    a1 = fout.a1_valid.cpu()
    check(bool((fout.n_attempts.cpu() == torch.where(a1, 1, 2)).all()),
          f"{tag}: n_attempts is not 2 exactly where attempt 1 failed")
    print(f"[{tag}] attempt 1 failed on frames "
          f"{torch.nonzero(~a1).flatten().tolist()}")
    coeffs = torch.cat([fout.left_coeffs, fout.right_coeffs]).cpu().numpy()
    check(np.isfinite(coeffs).all(), f"{tag}: non-finite coefficients")
    gate_oracle(tag, fout, oracles[f"bench_oracle_fail{FAIL_EVERY}"], H)
    # 'hoist' filters the whole chunk once; 'cond' filters each frame
    # whose attempt 1 failed, on its own.
    n_fail = int((~a1).sum())
    mode_launches = {
        "hoist": SECOND_ATTEMPT_LAUNCHES,
        "cond": {name: n * n_fail
                 for name, n in SECOND_ATTEMPT_LAUNCHES.items()},
    }
    for mode, want in mode_launches.items():
        fs.reset_launches()
        _, mout = chunk_process(fresh("cuda"), gfail,
                                fparams, cfg, second_attempt=mode)
        torch.cuda.synchronize()
        got = dict(fs.LAUNCHES)
        diff = same_outputs(mout, fout)
        print(f"[{tag}] '{mode}': launches {got} (second attempt expected "
              f"{want}); fields differing from two_phase {diff}")
        check(all(got[name] > 0 for name in ATTEMPT1),
              f"{tag}: '{mode}': an attempt-1 kernel did not launch")
        check(all(got[name] == n for name, n in want.items()),
              f"{tag}: '{mode}' did not launch the second attempt's kernels "
              f"{want}")
        check(not diff, f"{tag}: '{mode}' differs from two_phase")
    t0 = time.perf_counter()
    _, fcpu = chunk_process(fresh("cpu"), fail_chunk[:T_CPU],
                            fcpu_params, cfg, second_attempt="two_phase")
    print(f"[{tag}] CPU path T={T_CPU}: {time.perf_counter() - t0:.1f} s")
    compare_cpu(tag, fout, fcpu)

    # ---- 7. Filter route ----
    f65 = dataclasses.replace(f, ksize_b=65)
    fs.reset_launches()
    got = filter_stage(r, b, f65)
    route_launches = dict(fs.LAUNCHES)
    launches["bilateral_threshold"] = route_launches["bilateral_threshold"]
    print(f"[route] filter_stage ksize_b=65 launches {route_launches}")
    check(route_launches["bilateral_threshold"] == 1
          and route_launches["merge_open"] == 1
          and route_launches["thr_merge_open"] == 0,
          "ksize_b=65 did not take the standalone threshold + merge_open")
    rf = fs.tophat_ellipse_plain(r, f65.tophat_r)
    bf, rt, kp = fs.tophat_riders_plain(
        b, f65.tophat_b, [(rf, f65.ksize_r, f65.C_r, -1),
                          (b, f65.ksize_noise, f65.C_noise,
                           f65.noise_thresh)])
    want = fs.merge_open_plain(
        rt, fs.bilateral_threshold_plain(bf, f65.ksize_b, f65.C_b), kp,
        f65.open_k)
    route_err = [mismatches(got[0], want[0]),
                 mismatches(got[1].packed, want[1].packed)]
    print(f"[route] against the plain chain: mismatches "
          f"{[n for n, _ in route_err]}")
    check(all(n == 0 for n, _ in route_err),
          "the ksize_b=65 route disagrees with its plain chain")

    # ---- 8. Timing (not gated) ----
    def chunk_ms(frames_t, mode):
        """ms per chunk over N_TIMED_CHUNKS, state carried, after one
        warm-up chunk from a fresh state; and the last chunk's outputs."""
        st, _ = chunk_process(fresh("cuda"), frames_t, gparams, cfg,
                              second_attempt=mode)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(N_TIMED_CHUNKS):
            st, tout = chunk_process(st, frames_t, gparams, cfg,
                                     second_attempt=mode)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / N_TIMED_CHUNKS, tout

    # Every mode on both chunks, in turns: the spread of chunk times from
    # run to run is as wide as the modes' differences.
    for tag_t, frames_t in (("stills", gchunk), (tag, gfail)):
        for mode in TIMED_MODES + TIMED_MODES[::-1]:
            ms, tout = chunk_ms(frames_t, mode)
            print(f"[timing] {tag_t} chunk_process T={T_SLICE}, {mode}: "
                  f"{ms:.2f} ms/chunk, {T_SLICE * 1000.0 / ms:.1f} "
                  f"frames/s over {N_TIMED_CHUNKS} chunks, state carried "
                  f"({card})")
            if tag_t == "stills":
                check(bool(tout.valid.all()), "timed chunks lost tracking")

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
        # The neighborhood filter's two calls, as the fallback makes them.
        "adaptive_mean": (
            lambda: [fs.adaptive_mean(*a) for a in am_args],
            lambda: [fs.adaptive_mean_plain(*a) for a in am_args]),
        "merge_open": (
            lambda: fs.merge_open(r_am, b_am, open_k=f2.open_k),
            lambda: fs.merge_open_plain(r_am, b_am, open_k=f2.open_k)),
        "bilateral_threshold": (
            lambda: fs.bilateral_threshold(*bt_args[0]),
            lambda: fs.bilateral_threshold_plain(*bt_args[0])),
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
            "name": name, "route": "cuda", "source": fs.SOURCE[name],
            "replaces": fs.REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
        })

    # One fail16 chunk per mode under the profiler, read through its lt.*
    # ranges with scripts/torch_chunk_breakdown.py's reader; that script's
    # stills chunks never open the fallback's range, so it is added here.
    # In 'cond' each failing frame's lt.second_attempt nests inside
    # lt.back_half: the reader counts that range's host time in both, and
    # gives the back half's kernels launched after it to (outside).
    breakdown = importlib.import_module("scripts.torch_chunk_breakdown")
    trace = REPO / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(exist_ok=True)
    for mode in TIMED_MODES:
        st = fresh("cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk_process(st, gfail, gparams, cfg, second_attempt=mode)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        trace.unlink()
        with mock.patch.object(breakdown, "STAGES",
                               breakdown.STAGES + ("lt.second_attempt",)):
            stages = breakdown.stage_table(events, 1)
        busy = sum(v["device_ms"] for v in stages.values())
        print(f"[profile] {tag} chunk, {mode}, under torch.profiler: wall "
              f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1.0 - busy / wall_ms:.3f} ({card})")
        for name, v in stages.items():
            print(f"[profile]   {name:18s} host {v['host_ms']:10.3f} ms  "
                  f"device {v['device_ms']:9.3f} ms  launches "
                  f"{v['launches']:7.0f}")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
