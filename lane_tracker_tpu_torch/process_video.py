"""The video CLI.

Port of lane_tracker_tpu/process_video.py:27-219: load calibration,
construct the tracker's params and state, stream a video through the
chunk pipeline (``parallel.pipeline.chunk_process``) on the card, write
the annotated output, and print the success ratio.  The same arguments,
defaults and printed lines, plus ``--device`` (default ``cuda``; the
counterpart of the reference's ``JAX_PLATFORMS``).

Usage:
    python -m lane_tracker_tpu_torch input.mp4 output.mp4 \\
        --calibration assets/calibration.npz --preset demo1 [--chunk 32]

Inputs/outputs may be video files (needs ffmpeg on PATH), directories of
image frames (needs PIL), .npz frame stacks or .rgb24 raw streams.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="lane_tracker_tpu_torch",
        description="Lane detection and tracking over a video, on an "
        "NVIDIA GPU (PyTorch + CUDA).",
    )
    p.add_argument("input", help="video file, image directory, or .npz stack")
    p.add_argument("output", help="output video/.npz/directory")
    p.add_argument("--calibration", default="assets/calibration.npz")
    p.add_argument(
        "--preset",
        default="demo1",
        help="named parameter preset (committed/demo1/demo2/demo3)",
    )
    p.add_argument("--chunk", type=int, default=32, help="frames per device chunk")
    p.add_argument(
        "--pipeline",
        default="fast",
        choices=["fast", "compat"],
        help="channel-packed exact two-stage warp (fast) or the "
        "reference-exact LUT chain (compat); the reference's approximate "
        "'turbo' is not offered (it is not ported)",
    )
    p.add_argument(
        "--second-attempt",
        default="two_phase",
        choices=["two_phase", "cond", "hoist"],
        help="second-attempt schedule: 'two_phase' (chunk-level conditional "
        "batched fallback, free when every frame tracks), 'cond' (per "
        "failing frame inside the scan), or 'hoist' (unconditional: flat "
        "cost). All three give identical outputs "
        "(tests/test_torch_pipeline.py)",
    )
    p.add_argument("--n-fail", type=int, default=8)
    p.add_argument("--n-reset", type=int, default=4)
    p.add_argument("--n-average", type=int, default=2)
    p.add_argument("--print-frame-count", action="store_true")
    p.add_argument("--metrics-json", default=None, help="write per-run metrics here")
    p.add_argument(
        "--per-frame-log",
        default=None,
        help="write a JSONL line per frame (mode, validity, radius, ecc)",
    )
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace (trace.json) here")
    p.add_argument(
        "--no-output",
        action="store_true",
        help="headless: skip overlay rendering/fetch/encode, keep metrics "
        "and per-frame logs",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; 'cpu' runs the "
        "kernels' plain versions)",
    )
    return p


def run(argv=None):
    args = build_arg_parser().parse_args(argv)

    import torch

    from lane_tracker_tpu_torch.calib.io import load_calibration_npz
    from lane_tracker_tpu_torch.device import entry_device
    from lane_tracker_tpu_torch.io.video import open_sink, open_source
    from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
    from lane_tracker_tpu_torch.render.text import draw_text
    from lane_tracker_tpu_torch.tracker.config import PRESETS
    from lane_tracker_tpu_torch.tracker.step import (
        TrackerParams,
        make_initial_state,
    )
    from lane_tracker_tpu_torch.utils.profiling import FpsMeter, maybe_profile

    device = entry_device(args.device)
    cam, warp = load_calibration_npz(args.calibration)
    params = TrackerParams.build(
        cam.cam_matrix,
        cam.dist_coeffs,
        warp.M,
        warp.Minv,
        warp.image_width_height,
        warp.warped_width_height,
        warp.mppv,
        warp.mpph,
        pipeline=args.pipeline,
        device=device,
    )
    if args.preset not in PRESETS:
        raise SystemExit(
            f"unknown preset '{args.preset}'; available: {', '.join(sorted(PRESETS))}"
        )
    config = PRESETS[args.preset].replace(
        n_fail=args.n_fail, n_reset=args.n_reset, n_average=args.n_average
    )

    src = open_source(args.input)
    if tuple(src.size) != tuple(params.img_size):
        raise ValueError(
            f"input frames are {src.size}, calibration expects {params.img_size}"
        )
    sink = None if args.no_output else open_sink(args.output, src.size, src.fps)

    def step(state, chunk):
        return chunk_process(state, torch.from_numpy(chunk).to(device), params,
                             config, with_overlay=not args.no_output,
                             second_attempt=args.second_attempt)

    state = make_initial_state(config, params.warped_size, device)
    meter = FpsMeter()
    total = valid_total = 0
    frame_log = open(args.per_frame_log, "w") if args.per_frame_log else None

    def host(x):
        return x.cpu().numpy()

    def drain(outs, n_valid, base, metered=True):
        """Materialize one chunk's device outputs and do all host work."""
        nonlocal valid_total
        if metered:
            meter.add(n_valid)
        radii = host(outs.radius)
        eccs = host(outs.ecc)
        modes = host(outs.render_mode)
        if sink is not None:
            overlays = host(outs.overlay)  # a host copy, annotated in place
            # Host-side annotation (text never feeds back into tracking).
            for t in range(n_valid):
                f = overlays[t]
                if modes[t] == 0:
                    draw_text(f, f"Curve Radius: {int(radii[t])} m", (20, 35))
                    draw_text(f, f"Eccentricity: {eccs[t]:.2f} m", (20, 70))
                    if args.print_frame_count:
                        draw_text(f, f"Frame: {base + t}", (20, 105))
                else:
                    draw_text(f, "Lane Line Detection Failed", (20, 35))
                    if args.print_frame_count:
                        draw_text(f, f"Frame: {base + t}", (20, 70))
            sink.write(overlays, n_valid)
        if frame_log is not None:
            valids = host(outs.valid)
            detected = host(outs.detected)
            smodes = host(outs.search_mode)
            attempts = host(outs.n_attempts)
            for t in range(n_valid):
                frame_log.write(
                    json.dumps(
                        {
                            "frame": base + t,
                            "valid": bool(valids[t]),
                            "detected": bool(detected[t]),
                            "search_mode": "band" if smodes[t] else "sliding",
                            "attempts": int(attempts[t]),
                            "render": "lane" if modes[t] == 0 else "failure",
                            "radius_m": float(radii[t]),
                            "eccentricity_m": float(eccs[t]),
                        }
                    )
                    + "\n"
                )
        valid_total += int(host(outs.valid)[:n_valid].sum())

    with maybe_profile(args.profile_dir):
        # Double-buffered: queue chunk k+1's device work BEFORE
        # materializing chunk k's overlays, so the D2H transfer +
        # annotation + encode of one chunk overlap what the device still
        # has queued of the next (and the native loader's prefetch
        # overlaps both).
        pending = None
        first = True
        for chunk, n_valid in src.chunks(args.chunk):
            state, outs = step(state, chunk)
            if first:
                # Steady-state meter: the first chunk pays the one-time
                # kernel build and warm-up, which would swamp a short
                # run's fps; its frames are excluded from the meter too.
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                meter.reset()
            if pending is not None:
                drain(*pending)
            pending = (outs, n_valid, total, not first)
            total += n_valid
            first = False
        if pending is not None:
            drain(*pending)

    src.close()
    if sink is not None:
        sink.close()
    if frame_log is not None:
        frame_log.close()

    ratio = valid_total / max(total, 1)
    print(f"Success ratio:  {ratio}")
    print(f"Success absolute:  {valid_total}")
    print(f"Frames: {total} at {meter.fps():.1f} fps end-to-end (steady-state, first chunk excluded)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(
                {
                    "frames": total,
                    "valid_frames": valid_total,
                    "success_ratio": ratio,
                    "fps": meter.fps(),
                },
                f,
            )
    return 0


if __name__ == "__main__":
    sys.exit(run())
