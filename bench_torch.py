#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: chunk frames/s on one GPU.

The port of bench.py's ``_run`` (bench.py:140-331).  It measures the
chunked single-stream pipeline (the batched front half, the sequential
back half, the overlays) on 1280x720 dashcam frames with the demo1
parameter set, frames resident on the card, in chunks of ``BENCH_T``
frames (default 512), and gates the first chunk, from a fresh state,
on the live reference's oracle before it times anything.

    python bench_torch.py

Environment, as bench.py reads it:

* ``BENCH_PIPELINE``: the tracker pipeline, default 'corridor' (compute on
  the decision corridor plus its margin, each frame certified by
  ``corridor_ok``).  On the default, a frame whose certificate fails reruns
  the chunk in the full-width 'fast' pipeline, and the line says so; an
  explicit ``BENCH_PIPELINE=corridor`` raises instead.
* ``BENCH_T``: frames a chunk (512).
* ``BENCH_FAIL_EVERY=k``: every k-th still black, so attempt 1 fails and
  two_phase's fallback runs.
* ``BENCH_MOTION=1``: bench.py's motion frames (``io.motion.motion_chunk``,
  made on the card) instead of the four stills cycled.
* ``BENCH_CHUNKS``: chunks timed (5), after one warm-up chunk, the state
  carried from chunk to chunk.

The gates, on the first chunk: the validity trace equals the oracle's
(assets/bench_oracle.npz, bench_oracle_fail{k}.npz or
bench_oracle_motion.npz, as bench.py picks it) on every frame it covers,
and the curves' RMSE against its coefficients is at most 0.5 px (0.7672 px
on motion: the JAX package's own 0.7572 px at its knife-edge frame t=8
plus the 0.01 px fit contract).  bench.py only reports the RMSE; this
bench asserts it.  'turbo' and 'half' miss the budget by design and only
report both, as bench.py does.  A missing oracle raises, except for a
``BENCH_FAIL_EVERY`` no oracle was made for, whose RMSE is null.

Timing: a CUDA event pair around each timed chunk, and the host's clock
from before its first launch to a ``torch.cuda.synchronize()`` after it;
``value`` is T over the events' median chunk seconds.  The peak device
memory is read over the timed chunks.  Progress goes to stderr.  On
stdout, the line before the last gives the hand kernels' launches over
the first chunk and over the warm-up and timed chunks (``{"launches":
...}``), and the last line is the result, one JSON object.  Without CUDA
it raises; ``run(..., device="cpu")`` runs on the CPU (the tests; the
times are then the host's).
"""

from __future__ import annotations

import gc
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from lane_tracker_tpu_torch.calib.io import load_calibration_npz
from lane_tracker_tpu_torch.device import DEFAULT_DEVICE, entry_device
from lane_tracker_tpu_torch.io.motion import motion_chunk
from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.parallel.pipeline import build_chunk_processor
from lane_tracker_tpu_torch.tracker.config import PRESETS, halve_config
from lane_tracker_tpu_torch.tracker.step import (
    TrackerParams,
    make_initial_state,
)

REPO = pathlib.Path(__file__).resolve().parent
ASSETS = REPO / "assets"
METRIC = "1280x720 frames/sec/chip end-to-end process()"
RMSE_LIMIT_PX = 0.5
MOTION_RMSE_LIMIT_PX = 0.7672
# Pipelines that miss the 0.5 px budget by design: their trace and RMSE
# against the oracle are reported, not asserted (bench.py:249-254).
APPROXIMATE = ("turbo", "half")
# Variants whose oracle is committed: a missing file is an error.
ORACLE_VARIANTS = ("stills", "fail16", "motion")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def card(device) -> dict:
    """The device's name and power limit: ``torch.cuda.get_device_name``
    and the limit ``nvidia-smi --query-gpu=name,power.limit`` reads."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    limit = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            limit = smi.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except OSError:
        pass
    return {"name": torch.cuda.get_device_name(index), "power_limit": limit}


def build_params(pipeline: str, device=DEFAULT_DEVICE) -> TrackerParams:
    """The tracker's params from assets/calibration.npz."""
    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    return TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline=pipeline, device=device)


def bench_config(pipeline: str):
    """demo1; 'half' runs it halved to its warped space, as
    ``LaneTracker`` does (bench.py passes the full-size preset)."""
    cfg = PRESETS["demo1"]
    return halve_config(cfg) if pipeline == "half" else cfg


def cycled_stills(T: int, offset: int = 0) -> np.ndarray:
    """The four decoded stills (assets/stills_720p.npz) cycled to T
    frames from still ``offset``, (T, 720, 1280, 3) uint8."""
    with np.load(ASSETS / "stills_720p.npz") as z:
        stills = z["frames"]
    return stills[(offset + np.arange(T)) % len(stills)]


def variant_name(fail_every: int, motion: bool) -> str:
    return ("motion" if motion else f"fail{fail_every}" if fail_every
            else "stills")


def oracle_path(fail_every: int, motion: bool) -> pathlib.Path:
    """bench.py's choice of oracle (bench.py:238-240)."""
    return ASSETS / ("bench_oracle_motion.npz" if motion
                     else f"bench_oracle_fail{fail_every}.npz" if fail_every
                     else "bench_oracle.npz")


def make_frames(T: int, fail_every: int, motion: bool,
                device) -> torch.Tensor:
    """The bench chunk on ``device``: the motion frames (made there), or
    the stills cycled with every ``fail_every``-th frame black."""
    if motion:
        return motion_chunk(T, device=device)
    chunk = cycled_stills(T)
    if fail_every:
        chunk[::fail_every] = 0
    return torch.from_numpy(chunk).to(device)


def rescale_coeffs(coeffs, s: int) -> np.ndarray:
    """x(y) coefficients fitted in an s-times-downscaled warped space, in
    full-resolution warped coordinates (as scripts/approx_quality.py:28-42
    maps them): a full-resolution u is the downscaled (u - d) / s with
    d = (s - 1) / 2, so x_f(y_f) = s * x_h((y_f - d) / s) + d."""
    c2, c1, c0 = (float(c) for c in coeffs)
    d = (s - 1) / 2.0
    return np.array([s * c2 / (s * s),
                     s * (c1 / s - 2 * c2 * d / (s * s)),
                     s * (c2 * d * d / (s * s) - c1 * d / s + c0) + d])


def curve_rmse(mine, ref, H: int) -> float:
    """bench.py's RMSE of two x(y) curves over every warped row."""
    yy = np.arange(H, dtype=float)
    return float(np.sqrt(np.mean(
        (np.polyval(np.asarray(mine, float), yy)
         - np.polyval(np.asarray(ref, float), yy)) ** 2)))


def oracle_rmse(valid, left, right, oracle, H: int, res_scale: int = 1):
    """The per-curve RMSEs (bench.py:257-269) against the oracle on frames
    valid in both, over the H rows of the full-resolution warped space;
    coefficients fitted at 1 / ``res_scale`` of it are mapped there
    first."""
    rs = []
    for t in range(len(valid)):
        if not (valid[t] and oracle["valid"][t]):
            continue
        for mine, ref in ((left[t], oracle["left"][t]),
                          (right[t], oracle["right"][t])):
            if res_scale != 1:
                mine = rescale_coeffs(mine, res_scale)
            rs.append(curve_rmse(mine, ref, H))
    return rs


def load_oracle(path: pathlib.Path, variant: str):
    """The oracle's valid / left / right arrays; None where no oracle was
    made for this variant (a ``BENCH_FAIL_EVERY`` other than 16)."""
    if not path.is_file():
        if variant in ORACLE_VARIANTS:
            raise FileNotFoundError(f"the {variant} oracle {path} is missing")
        log(f"no oracle {path.name} for {variant}: the RMSE is not measured")
        return None
    with np.load(path) as z:
        return {k: z[k] for k in ("valid", "left", "right")}


def gate(outs, oracle, params: TrackerParams, limit: float, T: int) -> dict:
    """bench.py's quality gate on the first chunk: the validity trace
    against the oracle's over the frames it covers (asserted but for
    'turbo' and 'half'), and the RMSE against its curves (asserted here
    against ``limit``, but for 'turbo' and 'half')."""
    if oracle is None:
        return {"rmse_px_max": None, "rmse_px_mean": None,
                "rmse_gate_frames": None, "valid_mismatch_frames": 0}
    n_gate = min(T, len(oracle["valid"]))
    ov = oracle["valid"][:n_gate]
    mv = outs.valid[:n_gate].cpu().numpy()
    n_mismatch = int((mv != ov).sum())
    approximate = params.pipeline in APPROXIMATE
    if not approximate and n_mismatch:
        raise AssertionError(
            f"validity trace diverges from reference on {n_mismatch} of "
            f"{n_gate} frames: {np.flatnonzero(mv != ov).tolist()[:20]}")
    rs = oracle_rmse(mv, outs.left_coeffs[:n_gate].cpu().numpy(),
                     outs.right_coeffs[:n_gate].cpu().numpy(),
                     oracle, params.warped_size[1] * params.res_scale,
                     params.res_scale)
    if not rs:
        raise AssertionError("no frame is valid in both the run and the "
                             "oracle: nothing to gate the curves on")
    rmse_max, rmse_mean = float(np.max(rs)), float(np.mean(rs))
    log(f"first chunk against the oracle: {n_mismatch} of {n_gate} frames' "
        f"validity differ; rmse_px_max {rmse_max} (mean {rmse_mean}, limit "
        f"{limit}{', reported only' if approximate else ''})")
    if not approximate and rmse_max > limit:
        raise AssertionError(f"rmse_px_max {rmse_max} exceeds {limit} px")
    return {"rmse_px_max": rmse_max, "rmse_px_mean": rmse_mean,
            "rmse_gate_frames": n_gate,
            "valid_mismatch_frames": n_mismatch}


def timed_call(fn, device):
    """(result, device ms, wall ms) of one call of ``fn``: on CUDA a
    CUDA event pair around it, and the host's clock from before its first
    launch to a ``torch.cuda.synchronize()`` after it; on the CPU the
    host's clock for both."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        wall = (time.perf_counter() - t0) * 1e3
        return out, wall, wall
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, start.elapsed_time(end), wall


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(device):
    """``torch.cuda.max_memory_allocated()`` in GiB; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def release(device) -> None:
    """Return what freed tensors held to the card before the next run."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def spread(ms: list) -> dict:
    return {"median": float(np.median(ms)), "min": float(min(ms)),
            "max": float(max(ms))}


def first_chunk(frames, pipeline, explicit: bool, device):
    """The gated chunk from a fresh state, and the corridor certificate
    (bench.py:210-227).  On the default configuration a failed
    certificate reruns the chunk in 'fast' (bench.py re-executes itself
    with BENCH_PIPELINE=fast); an explicit 'corridor' raises.  Returns
    (params, config, state, outs, certificate) with certificate None
    unless 'corridor' was asked for, else (fraction, certified, frames
    failed)."""
    params = build_params(pipeline, device)
    config = bench_config(pipeline)
    step = build_chunk_processor(config, with_overlay=True,
                                 second_attempt="two_phase")
    state, outs = step(make_initial_state(config, params.warped_size, device),
                       frames, params)
    cert = None
    if pipeline == "corridor":
        ok = outs.corridor_ok.cpu().numpy()
        n_bad = int((~ok).sum())
        cert = (float(ok.mean()), n_bad == 0, n_bad)
        if n_bad:
            msg = f"corridor certificate failed on {n_bad} frames"
            if explicit:
                raise AssertionError(msg)
            log(f"{msg}; falling back to the full-width 'fast' pipeline")
            del state, outs
            release(device)
            params, config, state, outs, _ = first_chunk(
                frames, "fast", False, device)
    return params, config, state, outs, cert


def fired() -> dict:
    """The kernel wrappers' launch counts that are not 0."""
    return {name: n for name, n in fs.LAUNCHES.items() if n}


def time_chunks(config, state, frames, params, n_chunks: int,
                device) -> dict:
    """One warm-up chunk, then ``n_chunks`` timed chunks with the state
    carried; each chunk's outputs are dropped as it returns.  The line's
    timing keys; all None when ``n_chunks`` is 0."""
    keys = ("value", "chunk_ms_median", "chunk_ms_min", "chunk_ms_max",
            "wall_ms_median", "wall_ms_min", "wall_ms_max", "peak_mem_gib")
    if not n_chunks:
        return dict.fromkeys(keys)
    step = build_chunk_processor(config, with_overlay=True,
                                 second_attempt="two_phase")
    state = step(state, frames, params)[0]
    reset_peak(device)
    chunk_ms, wall_ms = [], []
    for i in range(n_chunks):
        state, ms, wall = timed_call(
            lambda: step(state, frames, params)[0], device)
        chunk_ms.append(ms)
        wall_ms.append(wall)
        log(f"timed chunk {i}: {ms:.3f} ms by events, {wall:.3f} ms wall")
    ev, wl = spread(chunk_ms), spread(wall_ms)
    return dict(zip(keys, (
        frames.shape[0] / (ev["median"] / 1e3), ev["median"], ev["min"],
        ev["max"], wl["median"], wl["min"], wl["max"], peak_gib(device))))


def run(T: int = 512, pipeline: str | None = None, fail_every: int = 0,
        motion: bool = False, n_chunks: int = 5,
        device=DEFAULT_DEVICE) -> dict:
    """The bench: frames, the gated first chunk, one warm-up chunk, then
    ``n_chunks`` timed chunks with the state carried (none, and no
    warm-up, for 0).  ``pipeline`` None is the default 'corridor' with
    its fallback to 'fast'.  Returns the JSON line's object."""
    device = entry_device(device)
    explicit = pipeline is not None
    variant = variant_name(fail_every, motion)
    oracle_arrays = load_oracle(oracle_path(fail_every, motion), variant)
    limit = MOTION_RMSE_LIMIT_PX if motion else RMSE_LIMIT_PX

    t0 = time.perf_counter()
    frames = make_frames(T, fail_every, motion, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"{variant} chunk {tuple(frames.shape)} on {device} in "
        f"{time.perf_counter() - t0:.2f} s")

    fs.reset_launches()
    params, config, state, outs, cert = first_chunk(
        frames, pipeline or "corridor", explicit, device)
    launches = {"first_chunk": fired()}
    res = gate(outs, oracle_arrays, params, limit, T)
    valid_fraction = int(outs.valid.sum()) / outs.valid.numel()
    if tuple(outs.overlay.shape) != tuple(frames.shape) or not torch.isfinite(
            torch.cat([outs.left_coeffs, outs.right_coeffs])).all():
        raise AssertionError("the first chunk's outputs are malformed")
    # Free the first chunk's outputs before the timed chunks, so that no
    # two chunks' outputs are held at once.
    del outs
    release(device)
    fs.reset_launches()
    timing = time_chunks(config, state, frames, params, n_chunks, device)
    launches["timed_chunks"] = fired()
    # The hand kernels' launches (the wrappers' counts; none on the CPU),
    # on a line of their own before the result.
    print(json.dumps({"launches": launches}), flush=True)

    line = {
        "metric": METRIC,
        "value": timing.pop("value"),
        "unit": "frames/s",
        "chunk_size": T,
        "valid_fraction": valid_fraction,
        **{k: res[k] for k in ("rmse_px_max", "rmse_px_mean",
                               "rmse_gate_frames")},
        "bench_variant": variant,
    }
    if params.pipeline != "fast" or cert is not None:
        line["pipeline"] = params.pipeline
        line["valid_mismatch_frames"] = res["valid_mismatch_frames"]
    if cert is not None:
        line["corridor_ok_fraction"] = cert[0]
        line["certified_exact"] = cert[1]
        if not cert[1]:
            line["corridor_failed_frames"] = cert[2]
    line.update(timing, timed_chunks=n_chunks, device=card(device))
    return line


def main() -> int:
    env = os.environ
    line = run(T=int(env.get("BENCH_T", "512")),
               pipeline=env.get("BENCH_PIPELINE"),
               fail_every=int(env.get("BENCH_FAIL_EVERY", "0")),
               motion=bool(int(env.get("BENCH_MOTION", "0"))),
               n_chunks=int(env.get("BENCH_CHUNKS", "5")))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
