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
   prefixes included, must match exactly.  The library's launch counter
   must show ``thr_merge_open`` in 2 kernel launches (the threshold, the
   bit-packed open + prefix tail) and ``merge_open`` in 1.
5. Slice: ``chunk_process`` (demo1, 'corridor', two_phase, overlay on) on
   the 64 stills from a fresh state; the attempt-1 kernels must have
   launched and the second attempt's not, the corridor certificate must
   hold on all frames, the validity trace must equal
   assets/bench_oracle.npz and the curves must be within 0.5 px RMSE of
   its coefficients; the back half must be one launch of the back-half
   kernel (kernels/back_half.py, by its library counter).  The CPU path
   on the first 8 frames must give the same integer decisions.
6. fail16 slice: the same on the fail16 chunk, which takes two_phase's
   fallback: two adaptive_mean launches and one merge_open; the trace must
   equal assets/bench_oracle_fail16.npz, n_attempts is 2 exactly where
   attempt 1 failed, the back half is two launches of the back-half
   kernel (the attempt-1 scan and the rescan); 'hoist' (the filter once
   per chunk: 2 and 1 launches; one back-half kernel) and 'cond' (once
   per failing frame: 2 and 1 launches each; no back-half kernel: the
   per-frame loop, whose fit sums round in another order) give
   two_phase's ints and bools exactly, its curves within 0.01 px RMSE and
   its overlay within the lane-edge contract, and the CPU path on the
   first 8 frames gives the same decisions.  Where the corridor certificate fails, the phase reruns
   in 'fast' (bench.py's rule), says so, and gates that run.
7. Filter route: ``filter_stage`` with ksize_b=65 launches the standalone
   threshold and merge_open and equals its plain chain.
8. Fused channel stage (kernels/channel_fused.py): on the slice's corridor
   channels, ``channel_stage`` on R, on LAB-B with the noise mask, and
   ``channel_stage_pyr`` on R, with the counts set to 0 just before and
   read just after (2 and 1 launches); each output must equal its plain
   twin and the unfused kernels (tophat_ellipse then bilateral_threshold)
   exactly.
9. Banded warp (kernels/resample_mxu2.py): ``MxuWarp2`` built from
   assets/calibration.npz at full geometry (1280x720 -> 1080x1100) warps
   the (R, LAB-B) pairs of the 64 raw stills (one pass-2 launch); pass 2
   must equal its twin exactly on the card and the warp the CPU path's on
   the first 4 frames.  How many values differ from the exact two-stage
   ``bilinear_gather`` warp (the design's fidelity loss) is printed, not
   gated.
11. Morphology probes (lane_tracker_tpu_torch/probes/mosaic.py; runs
   before phase 10): ``mosaic.run`` at the probes' full sizes, with the
   counts set to 0 just before and read just after.  Every one of the 64
   runnable shift-chain variants (1104x1280, K=64) must equal its plain
   twin with one call of its kernel (63 of ``lt_shift_chain``, one kernel
   launch each, and ``bf16_morph_chain8`` through ``lt_shift_chain_2d``,
   whose call takes the kernel launches the library's plan says,
   ``shift_chain.chain_plan``, counted by the library's launchers), and
   ``i16_sublane_slice_add_s17`` must be rejected; ``tophat_staged`` (bf16
   k=29 and 55, f32 k=29, probe 5's rows) and probe 4's ``tophat_ellipse``
   rows on (32, 1100, 1080) must equal the plain tophat; ``dual_tophat`` on
   the T=128 warped R and LAB-B must equal two ``tophat_ellipse`` calls and
   the twins.  The library's launch counter must show ``dual_tophat`` in 1
   kernel launch for both problems, two ``tophat_ellipse`` calls in 2, and
   each ``tophat_staged`` call in 1.  Probe 6's ``sweep_dots`` (32, 600, 1280) bf16 in each kind (3
   launches): swept equal to its twin's, out equal to the twin's for
   ``sweeps`` and within a relative 1e-4 of it (float64 sums) for ``dots``
   and ``both``; ``cuobjdump --dump-sass`` of the built library must show
   HGMMA (warpgroup tensor-core) instructions in its kernel.  Probe 11's
   ``tile_gather`` on (128, 1280) int32, each op at 16 and 64 reps (8
   launches): equal to its twin; the ``tile_gather_kernel`` instances of
   B0, G1 and G2 may hold no ``BAR.SYNC`` and G3's one (its rep loop's
   single barrier), and each instance's BAR.SYNC and SHFL counts go to the
   kernels line beside its ns a rep and each op's bound a rep, on 7-bit
   lanes four a word (``bound_ns_per_rep``) and at the int32 rate
   (``int32_bound_ns_per_rep``, the earlier yardstick).
12. User surface (runs before phase 10): ``LaneTracker`` built from
   assets/calibration.npz with no ``device`` argument runs ``process`` on 8
   stills with ``diagnostics=True`` (demo1, 'fast'): the attempt-1 kernels
   must launch once a frame (8 each, the second attempt's none), the
   validity must equal bench_oracle.npz[:8] with curves within 0.5 px,
   and the transcript and the decisions must equal the port's CPU run of
   the same frames; ``process_chunk`` on the same frames from a fresh
   state (the back-half kernel) must give ``process``'s (the per-frame
   loop) ints, bools and success ratio exactly, its curves within 0.01
   px RMSE and its overlay within the lane-edge contract; a ``save_state`` /
   ``load_state`` round trip after frame 3 must continue identically;
   ``visualize_search`` and ``split_view`` must return the reference's
   shapes.  'compat' ``chunk_process`` on the 64 stills (two_phase): the
   attempt-1 kernels must launch, every launch at width 1080, validity
   equal to bench_oracle.npz with curves within 0.5 px, and the CPU path
   on the first 8 frames the same decisions.  ``filter_stage`` with
   'neighborhood' + ``mask_noise`` on the slice's channels must launch
   ``adaptive_mean`` 2, the standalone threshold 1 and ``merge_open`` 1
   and equal its plain chain.  The CLI, ``python -m
   lane_tracker_tpu_torch``, in a subprocess on a 64-frame ``.npz``
   (``--chunk 32 --per-frame-log --metrics-json``) must exit 0 with its
   log's validity equal to the oracle's.
13. Fleet (runs before phase 10): ``parallel.StreamFleet`` built with no
   device list (its states must be on the card), demo1 'fast', S=8
   streams of T=32 frames (256 a step), overlay on; stream s the four
   stills cycled from offset s; scripts/fleet_bench.py's loads all_valid,
   fail16 (stream 0's every 16th frame black), fail16_all and dead_stream
   (stream 0 black).  First the five filter wrappers of the fleet's path
   against their plain twins on all_valid's flat 256-frame channels, as
   phase 4 holds them at 64 (every output equal).  Gated on each load: 'two_phase', 'hoist' and 'auto'
   give identical outputs and metrics; each stream equals the port's own
   ``chunk_process`` ('hoist', fresh state) on its frames (decisions and
   integer state identical, curves within 0.01 px, the overlay within 1
   but on a lane edge's ramp, tests/test_torch_pipeline_presets.py's
   contract); the metrics are the outputs' int32 sums over 256 frames;
   the step's wrapper calls are one of each attempt-1 kernel (1 / 3 / 2
   kernel launches, by the library's count around each wrapper call) and
   the fallback's ``adaptive_mean`` / ``merge_open`` (2 / 1) in every
   'hoist' step and in a 'two_phase' step exactly when some attempt 1
   failed, no other kernel of the library in the step, the same for one
   stream alone.  Stream 0 meets bench_oracle.npz[:32] on all_valid and
   bench_oracle_fail16.npz[:32] on fail16; on dead_stream stream 0 detects
   nothing and the others every frame.  'auto' takes 8 dead_stream steps
   and resolves to 'hoist', its schedule after each step equal to a host
   replay of the EMA rule.  The CPU path (``devices=("cpu",)``, streams
   0-1, 4 frames of fail16) gives the card's decisions.  Printed: frames/s
   and ms a frame of each schedule and load in turns (median of 3 steps
   after the gate step, by CUDA events), valid fractions, peak device
   memory.  The phase then releases its memory to the card, and
   ``LaneTracker.process`` is timed before it as in phase 10 after it.
   At the very end, after phase 10's profiles (once a profiler
   has traced the card, a process's later launches cost more, so no
   trace runs before a timing): the back half's launches per time step at S=1 and S=8 under
   torch.profiler (gated: S=8 at most twice S=1), and one fail16
   two_phase step under the profiler by ``lt.*`` range.
14. Gaps (runs after phase 13, before phase 10): the motion frames
   (``io.motion.motion_chunk``, bench.py's BENCH_MOTION=1 chunk without
   OpenCV) made on the card must equal the CPU generator's at t = 0, 8,
   37, 150, 300, 451 and 511, every value.  ``chunk_process`` (demo1,
   'corridor', two_phase, overlay on, fresh state) at bench.py's T=512 on
   the stills, fail16 and motion chunks, each gated against all 512 frames
   of its oracle (assets/bench_oracle.npz, bench_oracle_fail16.npz,
   bench_oracle_motion.npz): the validity trace equal, the curves within
   0.5 px RMSE (stills, fail16) or 0.7672 px (motion: the JAX package's
   own 0.7572 px at its knife-edge frame t=8, docs/PERFORMANCE.md, plus
   the port's 0.01 px fit contract), the corridor certificate on every
   frame or else a rerun in 'fast' that says so and is gated; the
   attempt-1 kernels launched, the fallback's exactly when some attempt 1
   failed; printed: ms a chunk (one run, not a timing claim) and the peak
   device memory.  The phase then releases its memory and prints its wall time, and
   ``LaneTracker.process`` is timed right before and right after it.
15. Opt-in modes (runs after phase 14, before phase 10): (a) 'turbo' and
   (b) 'half' (demo1, halved by ``halve_config`` for 'half') through
   ``chunk_process`` (two_phase, overlay on, fresh state) on the 64
   stills and the fail16 chunk: the attempt-1 kernels launched, the
   fallback's exactly when some attempt 1 failed, the validity trace equal
   to the JAX package's (assets/mode_oracle.npz, written on the CPU by
   scripts/torch_mode_oracle.py) on all 64 frames and the curves within
   0.01 px RMSE of its; the first 8 frames (outputs and final state) equal
   to the port's CPU run, decisions and integer state exactly, curves
   within 0.01 px; printed, not gated: the trace and ``rmse_px_max``
   against assets/bench_oracle*.npz ('half''s curves mapped to full
   resolution), beside the JAX package's own on the same frames.  Before
   the chunks, (d) the five filter wrappers against their plain twins at
   each pipeline's channels ('turbo''s (64, 1100, 1080), 'half''s (64, 550,
   540) at the halved sizes and ``SECOND_ATTEMPT_HALF``'s).  (c)
   ``LaneTracker(latency_mode=True)`` on 8 stills, 'fast' and 'turbo',
   equal to ``latency_mode=False`` in every output and annotated frame;
   ``warp_channels`` at T=1 by rowmm equal to the gather bit for bit;
   printed: both warps' and both ``process`` calls' ms a frame (median of
   16 after 4 warm-up, CUDA events) and the one-hot tensors' bytes.  (e)
   Printed, no claim: 'fast', 'turbo' and 'half' in turns, the stills
   chunk's ms (state carried) and ``warp_channels``' ms a chunk (the
   ``lt.warp_lab`` range's work), and peak device memory.  Each path's
   launches go to the kernels line's ``path_launches``.  The phase then
   releases its memory, and ``LaneTracker.process`` is timed after it.
16. Bench (runs after phase 15, before phase 10): the measuring entry
   points as a user runs them, each in a process of its own that reuses
   the kernels built in phase 2, every line it writes printed.
   ``python bench_torch.py`` with no BENCH_ variable set (T=512, 'corridor'
   with its fallback to 'fast', two_phase, overlay on), then with
   BENCH_FAIL_EVERY=16 and with BENCH_MOTION=1 (each with BENCH_CHUNKS=2,
   also at T=512): each must exit 0 with a
   last line that parses, names this card and its power limit, has
   ``chunk_size`` 512, ``certified_exact`` true or the recorded 'fast'
   fallback, ``rmse_px_max`` within 0.5 px (motion 0.7672) over all 512
   frames, ``valid_fraction`` the oracle's (1.0 on the stills), a time and
   no TPU ratio; its launch line must show the attempt-1 kernels in the
   first chunk and in the timed ones, and the fallback's exactly on fail16
   and motion.  ``scripts/torch_latency_bench.py 1 64`` must give the
   rows ('corridor', then 'fast') x (1, 64) with their keys, and
   ``FLEET_LOADS=fail16 scripts/torch_fleet_bench.py 8 32`` one row per
   schedule with their keys, 'auto''s resolved schedule and one valid
   fraction.  The phase prints its seconds.
17. Back half (runs after phase 16, before phase 10): the back-half
   kernel against its plain twins at the main path's shapes, on the
   T=512 motion frames (scene 1, where attempt 1 fails, and the black
   frames 450-455), 'fast', demo1, from a fresh state: one stream
   (``scan_back_half`` against ``scan_back_half_plain``) and 16 streams of
   32 of those frames (``kernels.back_half.scan`` against
   ``scan_streams_plain``), each with one attempt and with the hoisted
   second attempt.  Every int and bool of the outputs and the end state
   must be equal and the fits and graphs within 0.01 px over the warped
   rows; each scan must be one launch by the kernel's own counter
   (``lt_back_half_launches``) and none by the filter stage's.  Timed: the
   kernel queued behind a spin (``timing.queued_ms``, its row's ``ms``)
   and by CUDA events, the twin's one scan on the host's clock, the bound
   (the scan's bytes at the HBM rate: it is latency-bound); the kernels
   line's ``back_half`` entry is the one-stream two-attempt scan, with
   every case in its ``cases``.
18. Warp + LAB (runs after phase 17, before phase 10): the warp + LAB
   kernels (kernels/warp_lab.py) against their plain twin
   (``warp_rows_plain``) at the main path's shapes, on the T=512 motion
   frames (black at 450-455), in 'fast' and 'corridor': the offline
   chunk's slice (``tracker.upload.slice_frames``, 36 frames), the whole
   chunk, and the fleet's batch of 16 streams of 32 as its step gathers
   it.  Every R and LAB-B pixel must equal the twin's, and each call be
   one call of the wrapper, two kernels by the library's own counter
   (``lt_warp_lab_launches``) and its frames in
   ``lt.warp_lab.kernel_frames``.  Then, each count set to 0 just
   before, ``LaneTracker.process_chunk`` of the 512 frames from the host
   must call the kernels once a slice and a 16 x 32 ``StreamFleet`` step
   once.  Timed: the kernels queued behind a spin (``timing.queued_ms``)
   and by CUDA events, the twin (32 frames a call) by CUDA events, in
   turns; the bound is ``benchmark/roofline.warp_lab_s`` of the call's
   shape (the raw rows read once, the two planes written once).  The
   kernels line's ``warp_lab`` entry is 'fast''s slice, with every case
   in its ``cases``, the process_chunk counts in ``path_launches`` and
   the fleet step's in ``fleet_launches``.
10. Timing (printed, not gated): frames/s of the stills and the fail16
   chunks in each second-attempt mode, in turns, with state carried;
   ``LaneTracker.process`` ms a frame (median over 16 frames after a
   warm-up, by CUDA events) and the CLI's fps line;
   per-kernel times against the plain twins with CUDA events; rows 1-5
   and the fused stage launch by launch (each tophat and threshold entry
   alone, the open + prefix tail of rows 3 and 5 alone and row 5's whole
   call, the adaptive mean at k=15 and k=35, the fused stage's R, B + noise
   and pyr calls, each with its own bound, ``launches_ms`` in the row's
   entry); the
   probes' rows, each timed once (us per pass of each shift chain, ms per frame of
   each tophat row and of probe 6's kinds, ns per rep of probe 11's
   gathers), with their bounds and the shuffle and shared-memory traffic
   of each chain's design per pass, summed into the probe kernels' entries of the
   kernels line (probe 6's with the batched ``torch.matmul`` of its
   products as ``library_ms``, beside the ``dots`` row's own ms as
   ``library_of`` / ``library_of_ms``: the library computes that row's
   products, not all three kinds); the fused stage at several tiles
   against the unfused kernels (scripts/mosaic_probe7.py's study on this
   card); the banded warp against the two-stage warp; and a profile of one
   fail16 chunk per mode read through its ``lt.*`` ranges.

The line before the last is a JSON object describing each kernel, with
its bound: the larger of the bytes it must move over the HBM rate and the
operations it does over the card's rate for their type (``bound``); the
last line is ``{"ok": true, "device": {...}}``.  Each kernel's entry
also carries ``path_launches``: its launches on phase 12's paths
(``process`` over 8 frames, 'compat' on 64, 'neighborhood' + mask_noise)
phase 15's ('turbo' and 'half' on each chunk, the latency mode's two
trackers over 8 frames each) and phase 16's (each bench variant's first
chunk, as its launch line gives them),
and ``fleet_launches``: its wrapper's calls in each schedule's first
phase 13 step on each load, ``fleet_kernel_launches``: the kernels those
calls launched by the library's own count, and ``fleet_max_abs_err``: its
largest difference from its plain twin on the fleet's batch.  Without CUDA, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import functools
import importlib
import io
import json
import os
import pathlib
import re
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
FUSED_LAUNCHES = {"channel_stage": 2, "channel_stage_pyr": 1}
N_PROCESS = 8
N_PROCESS_TIMED = 16
CLI_CHUNK = 32
NEIGHBORHOOD_NOISE_LAUNCHES = {"adaptive_mean": 2, "bilateral_threshold": 1,
                               "merge_open": 1}
# The launchers compat's width is checked on: each takes its image first.
LAUNCHERS = ("_launch_tophat", "_launch_threshold", "_launch_thr_merge_open",
             "_launch_merge_open", "_launch_adaptive_mean")
T_WARP_CPU = 4
# Phase 13, the fleet: scripts/fleet_bench.py's default cell (S streams of
# T frames, pipeline 'fast', overlay on) and its four loads.
T_BENCH = 512  # bench.py's chunk, and the oracles' length
# The motion chunk's curve bound: the JAX package's own 0.7572 px at its
# knife-edge frame t=8 (docs/PERFORMANCE.md, "The motion outlier") plus
# the port's fit contract, 0.01 px.
MOTION_RMSE_LIMIT_PX = 0.7672
MOTION_SAMPLED = (0, 8, 37, 150, 300, 451, 511)
# Phase 15, the opt-in modes: 'turbo' and 'half' against the JAX package's
# results (assets/mode_oracle.npz, scripts/torch_mode_oracle.py) within the
# fit contract; the latency mode on 'fast' and 'turbo'; the times.
MODE_PIPELINES = ("turbo", "half")
MODE_RMSE_LIMIT_PX = 0.01
LATENCY_PIPELINES = ("fast", "turbo")
TIMED_PIPELINES = ("fast", "turbo", "half")
MODE_TIMED_CHUNKS = 3
# Phase 16, the measuring entry points, each in a process of its own:
# bench_torch.py's three variants at its default T=512 (the stills with no
# variable set; fail16 and motion, whose chunks take 2.2-2.5x as long,
# timing 2 chunks instead of 5, so that the phase stays near 4 minutes),
# the latency sweep at two chunk sizes, the fleet bench on one load.
BENCH_VARIANTS = (("stills", {}, RMSE_LIMIT_PX),
                  ("fail16", {"BENCH_FAIL_EVERY": "16", "BENCH_CHUNKS": "2"},
                   RMSE_LIMIT_PX),
                  ("motion", {"BENCH_MOTION": "1", "BENCH_CHUNKS": "2"},
                   MOTION_RMSE_LIMIT_PX))
LATENCY_ARGS = ("1", "64")
FLEET_BENCH = (("8", "32"), {"FLEET_LOADS": "fail16"})
ENTRY_TIMEOUT_S = 600
# Launches of the back-half kernel (kernels/back_half.py, its library
# counter) in a 64-frame chunk: two_phase scans once on the stills and
# rescans on fail16, 'hoist' scans once, 'cond' keeps the per-frame loop.
BACK_HALF_LAUNCHES = {"stills": 1, "two_phase": 2, "hoist": 1, "cond": 0}
# Phase 17, the back-half kernel against its twins at the main path's
# shapes: one stream of T_BENCH motion frames, 16 streams of 32; fits and
# graphs within BACK_HALF_PX of the twins' over the warped rows.
BACK_HALF_STREAMS = (16, 32)
BACK_HALF_PX = 1e-2
BACK_HALF_REPS = 5
# Phase 18, the warp + LAB kernels against their twin at the main path's
# shapes, in the pipelines of the benchmark's cells: the offline chunk's
# slice, bench.py's T_BENCH chunk and the fleet's batch of 16 streams of
# 32; the twin runs WARP_LAB_TWIN_T frames a call (its float64
# intermediates grow with the call).
WARP_LAB_PIPELINES = ("fast", "corridor")
WARP_LAB_STREAMS = (16, 32)
WARP_LAB_TWIN_T = 32
WARP_LAB_REPS = 10
ENTRY_ENV = ("BENCH_", "LATENCY_", "FLEET_")
LATENCY_KEYS = ("pipeline", "chunk", "fps", "ms_per_frame",
                "chunk_compute_ms", "peak_mem_gib", "device")
FLEET_KEYS = ("streams", "chunk", "schedule", "load", "aggregate_fps",
              "valid_fraction", "peak_mem_gib", "device")
FLEET_S = 8
FLEET_T = 32
FLEET_PIPELINE = "fast"
FLEET_LOADS = ("all_valid", "fail16", "fail16_all", "dead_stream")
FLEET_SCHEDULES = ("two_phase", "hoist", "auto")
FLEET_TIMED_STEPS = 3
FLEET_AUTO_STEPS = 8
FLEET_CPU = (2, 4)  # streams, frames of the CPU fleet
FLEET_LAUNCH_T = 4  # time steps of the back half's launch count
FLEET_CURVE_PX = 0.01
# Kernels attempt 1's filter wrappers launch in one fleet step, whatever S
# is, as the library counts them (demo1: the riders are the R threshold and
# the noise keep-mask); the fallback's wrappers launch one kernel a call.
FLEET_KERNELS = {"tophat_ellipse": 1, "tophat_riders": 3, "thr_merge_open": 2}
# tests/test_torch_pipeline_presets.py's overlay contract at a lane edge:
# a value may move by up to rint(0.3 * 255) on a one-column coverage
# ramp, at most EDGE_VALUES_MAX values of a chunk more than 1; R and B
# untouched.
EDGE_COLUMN_MAX = 77
EDGE_VALUES_MAX = 64
# tests/test_torch_fleet.py's coefficient fields of the state, held in px
# of the curve; the exact fields are those of an integer or bool dtype.
COEFF_STATE = ("hist_left", "hist_right", "last_left", "last_right",
               "avg_left", "avg_right")
MXU_DST = (1080, 1100)  # the bird's-eye size, calibration.npz's warped size
# The card's peak rates (H100 SXM data sheet, dense, at 700 W): HBM bytes/s,
# f32 operations/s outside the tensor cores, and int32 at half that; bf16
# multiply-adds on the tensor cores (989.4 TFLOP/s dense, the same sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
I32_OPS_PER_S = F32_OPS_PER_S / 2
BF16_TENSOR_FLOPS_PER_S = 989.4e12
# Operations/s by the type they run in, for every bound: int32 at the int32
# rate, f32 at the f32 rate, and the narrow types as packed SIMD (bf16x2
# __hmin2 / __hadd2; two int16 or four 8-bit lanes a word with __vmins2 /
# __vadd2 / __vminu4), at the 32-bit rate times the lanes a word holds: the
# least time the card could take.  So a uint8 tophat's min/max and subtract
# run at the uint8 rate, a threshold's sums of pixels at the int32 rate.
OPS_PER_S = {"int32": I32_OPS_PER_S, "int16": 2 * I32_OPS_PER_S,
             "uint8": 4 * I32_OPS_PER_S, "int8": 4 * I32_OPS_PER_S,
             "float32": F32_OPS_PER_S, "bfloat16": 2 * F32_OPS_PER_S,
             "bfloat16_tensor": BF16_TENSOR_FLOPS_PER_S}
# Integer operations per pixel of the kernels' stages, as the kernels do
# them: a cross threshold's two prefix adds, four arm differences, k*x - C*k,
# four compares, three logic ops and the select (int32: sums of pixels); the
# noise mask's compare and or, a merge's or and and (uint8: pixels and
# masks); a packed row prefix's pack and add, the adaptive mean's two
# integral adds, three box adds, four for the compare and the select
# (int32).  Pass 2 of the banded warp: a product, an fma, rint and two
# clamps in f32.
THRESHOLD_OPS = 16
NOISE_OPS = 2
MERGE_OPS = 2
PREFIX_OPS = 3
ADAPTIVE_OPS = 10
PASS2_FLOPS = 6
PROBE_LAUNCHES = {"shift_chain": 63, "shift_chain_2d": 1, "tophat_staged": 3,
                  "dual_tophat": 1, "tophat_ellipse": 4, "sweep_dots": 3,
                  "tile_gather": 8}
PROBE_KERNELS = ("shift_chain", "shift_chain_2d", "tophat_staged",
                 "dual_tophat", "sweep_dots", "tile_gather")
PROBE_REPS = 10
DUAL_LAUNCHES = 1
LAUNCH_REPS = 10
# Operations per element and rep of probe 11's chains: the add, one select
# for each gather, the mask.  Only the low 7 bits of an element reach the
# output ((s + prev) & 0x7F == ((s & 0x7F) + prev) & 0x7F), so the least the
# card could do runs them on 7-bit lanes four a word, at the uint8 rate; the
# int32 rate of the same counts is kept beside it as the earlier yardstick.
GATHER_OPS = {"B0_plain_add": 2, "G1_lane_gather": 3, "G2_sublane_gather": 3,
              "G3_2d_gather": 4}
# The int32 arrays each op's function reads: src, li for a lane gather, si
# for a sublane gather.
GATHER_READS = {"B0_plain_add": 1, "G1_lane_gather": 2, "G2_sublane_gather": 2,
                "G3_2d_gather": 3}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def mismatches(a, b):
    """(number of differing elements, max abs difference) of two tensors."""
    d = (a.long() - b.long()).abs()
    return int((d != 0).sum()), int(d.max())


def bound(nbytes, *ops):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of ``nbytes`` over the HBM rate and the time of the operations,
    each ``(count, type)`` at ``OPS_PER_S[type]``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / OPS_PER_S[t] for n, t in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def morph_ops(k):
    """Integer operations per pixel of an erode or dilate with the odd
    k x k ellipse: the fewer of the port's two decompositions.  A pow2
    window pyramid takes one per level above the first and two per SE row
    (the op of the two level reads, and into the accumulator); lt_tophat's
    widening takes two per step of its horizontal window (h to h + s,
    s <= 2h + 1, through the ellipse's distinct half-widths) and one per
    SE row."""
    from lane_tracker_tpu_torch.ops.morphology import ellipse_runs

    runs = ellipse_runs(int(k))
    max_run = max(hi - lo + 1 for _, (lo, hi) in runs)
    pyramid = (max_run.bit_length() - 1) + 2 * len(runs)
    steps, h = 0, 0
    for u in sorted({hi for _, (_, hi) in runs} - {0}):
        while h < u:
            h += min(u - h, 2 * h + 1)
            steps += 1
    return min(pyramid, 2 * steps + len(runs))


def tophat_ops(k):
    return 2 * morph_ops(k) + 1


def chain_work(v, x, k):
    """(bytes, (operations, their type)) of a shift chain on block x: one
    read and one write of the block; the body's operations per element in
    each of its passes."""
    from lane_tracker_tpu_torch.kernels import shift_chain as sc

    n = x.numel()
    return (2 * n * x.element_size(),
            (n * v.n_passes(k) * sc.BODY_OPS[v.body], v.dtype))


def chain_traffic_per_pass(v, x):
    """Bytes one pass of the design moves besides its registers (its cost,
    not the bound), from the library's plan of the call
    (``shift_chain.chain_plan``): {"shuffle": bytes of register words one
    lane hands another, "shared": bytes of shared memory read and
    written}.  A line in orbit order (one warp) shuffles one 32-bit word a
    lane a pass; the probes' packed-u16 pair on a row of 32 runs shuffles
    nine words a lane; the plain order writes a line's words (a roll's
    twice where the line spans warps) and reads each neighbour back; the
    elementwise bodies stay in registers; an outer step of the 2-D chain
    (4 passes) reads and writes each word of its tiles' regions in shared
    memory: the column rolls read x over a run and the 5 words below it
    and write q, the row rolls read q over a run and the 9 rows above it,
    read x and write it."""
    from lane_tracker_tpu_torch.kernels import shift_chain as sc

    h, w = x.shape
    if v.boundary is None:
        return {"shuffle": 0, "shared": 0}
    plan = sc.chain_plan(v, h, w)
    if v.body == "morph_chain8":
        region = plan["tiles"] * plan["rh"] * plan["rww"] * 4
        per_step = ((plan["run_w"] + 5) / plan["run_w"] + 1
                    + (plan["run_h"] + 9) / plan["run_h"] + 2)
        return {"shuffle": 0, "shared": per_step * region / 4}
    n_lines, length = (h, w) if v.axis == 1 else (w, h)
    packed = -(-n_lines // (4 // x.element_size()))
    if (v.body == "packed" and v.shifts == (8, 9)
            and length == 32 * plan["regs"]):
        # the pair in registers: the previous lane's last nine words
        return {"shuffle": packed * 32 * 9 * 4, "shared": 0}
    if plan["mode"] != "orbit":
        writes = 2 if plan["mode"] == "plain" and v.boundary == "circular" else 1
        return {"shuffle": 0,
                "shared": packed * (writes + len(v.shifts)) * length * 4}
    # 8-bit lines pass in two halves, a word each a lane
    halves = 2 if x.element_size() == 1 else 1
    return {"shuffle": halves * packed * plan["lanes"] * 4, "shared": 0}


def sweep_dots_work(kind):
    """(bytes, (operations, their type), ...) of one sweep_dots call at the
    probe's size: x and tri read once and out written once, as the TPU
    kernel moves them (its swept scratch stays in VMEM; the port's write of
    ``swept`` is work of its design, not of the function); a min and an add
    per swept element and sweep (bf16), the three products' multiply-adds
    (2 operations each, on the tensor cores), and the f32 sums of the
    products' outputs and of the 8 x 128 corner."""
    from lane_tracker_tpu_torch.kernels import sweep_dots as sd

    frame = sd.T * sd.ROWS * sd.COLS * 2
    ops = [(sd.T * 8 * 128, "float32")]
    if sd.KINDS[kind] & 1:
        ops.append((2 * sd.SWEEPS * (sd.ROWS - sd.UNSWEPT) * sd.COLS * sd.T,
                    "bfloat16"))
    if sd.KINDS[kind] & 2:
        ops.append((2 * sd.N_BLOCKS * sd.T * sd.BLOCK * sd.KP * sd.NP,
                    "bfloat16_tensor"))
        ops.append((sd.N_BLOCKS * sd.T * sd.BLOCK * sd.NP, "float32"))
    return (frame + 2 * sd.KP * sd.NP + 4 * sd.T, *ops)


def gather_work(op, reps, lanes="uint8"):
    """(bytes, (operations, type)) of one tile_gather call: the arrays op
    reads, read once, and the output written once, GATHER_OPS operations
    per element and rep on ``lanes``."""
    from lane_tracker_tpu_torch.kernels import tile_gather as tg

    n = tg.H * tg.W
    return (4 * n * (GATHER_READS[op] + 1),
            (n * reps * GATHER_OPS[op], lanes))


def gather_bound_ns_per_rep(op, lanes):
    """ns a rep of one tile_gather call's operations on ``lanes``."""
    _, (ops, t) = gather_work(op, 1, lanes)
    return ops / OPS_PER_S[t] * 1e9


@functools.lru_cache(maxsize=None)
def sass_dump(lib_path):
    """``cuobjdump --dump-sass`` of the library, once a run."""
    from lane_tracker_tpu_torch.kernels.build import find_nvcc

    tool = pathlib.Path(find_nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
    return res.stdout


def sass_count(lib_path, kernel, opcode):
    """(count, function names): the instructions with ``opcode`` in the
    SASS of the library's functions whose mangled name holds ``kernel``,
    from ``cuobjdump --dump-sass``."""
    count, names, name = 0, set(), None
    for line in sass_dump(lib_path).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and kernel in name and re.search(rf"\b{opcode}\b", line):
            count += 1
            names.add(name)
    return count, sorted(names)


def single_launches(f, f2, r, b, r_feat, b_feat, r_th, keep, r_am, b_am):
    """Rows 1-5 and the fused stage's launch by launch: (row, launch, work,
    call), each call one launch of that entry alone on the main path's
    input, through the library's C interface, not counted; work is its
    (bytes, (operations, their type), ...).  Row 3's second launch is the
    tail with its merge ((r | b_th) & keep) in the load, row 5's whole call
    the tail with (r | b); lt_open_prefix is the tail alone on each row's
    merged image.  Row 4: the adaptive mean at the fallback's two k; the
    fused stage: R, B with the noise mask, and the pyr entry's R."""
    import torch

    from lane_tracker_tpu_torch.kernels import channel_fused as cf
    from lane_tracker_tpu_torch.kernels import filter_stage as fs

    N = r.numel()
    pref_bytes = 4 * N // r.shape[-1] * (r.shape[-1] + 1)
    u8, i32 = "uint8", "int32"

    def tophat(img, k):
        return (f"lt_tophat k={k}", (2 * N, (N * tophat_ops(k), u8)),
                lambda: fs._launch_tophat(img, k))

    def threshold(img, k, C, nt):
        ops = [(N * THRESHOLD_OPS, i32)] + ([(N * NOISE_OPS, u8)]
                                             if nt >= 0 else [])
        return (f"lt_cross_threshold k={k}" + (" noise mask" if nt >= 0
                                                else ""),
                (2 * N, *ops), lambda: fs._launch_threshold(img, k, C, nt))

    def tail(k, merged=None, merge=None):
        """The tail alone on a merged image, or with the merge of `merge`
        = (r, b, keep) in its load."""
        n_in = 1 if merged is not None else sum(x is not None for x in merge)
        morph = 2 * morph_ops(k) + (0 if merged is not None else MERGE_OPS)
        work = ((n_in + 1) * N + pref_bytes, (N * morph, u8),
                (N * PREFIX_OPS, i32))
        if merged is not None:
            return (f"lt_open_prefix k={k}", work,
                    lambda: fs._launch_open_prefix(merged, k))
        return (f"lt_merge_open k={k}, {n_in} inputs", work,
                lambda: fs._launch_merge_open(*merge, k))

    def adaptive(img, k, C):
        return (f"lt_adaptive_mean k={k}", (2 * N, (N * ADAPTIVE_OPS, i32)),
                lambda: fs._launch_adaptive_mean(img, k, C))

    def fused(tag, img, kt, kb, C, noise=None):
        n_out, ops = 1, tophat_ops(kt)
        if noise:
            n_out, ops = 2, ops + NOISE_OPS
        return (f"lt_channel_stage {tag} kt={kt} kb={kb}"
                + (f" noise kn={noise[0]}" if noise else ""),
                ((1 + n_out) * N, (N * ops, u8),
                 (N * n_out * THRESHOLD_OPS, i32)),
                lambda: cf._launch(img, kt, kb, C, noise, None))

    noise = (f.ksize_noise, f.C_noise, f.noise_thresh)
    b_th = fs.bilateral_threshold_plain(b_feat, f.ksize_b, f.C_b)
    merged3 = torch.where(((r_th > 0) | (b_th > 0)) & (keep > 0), 255,
                          0).to(torch.uint8)
    merged5 = torch.where((r_am > 0) | (b_am > 0), 255, 0).to(torch.uint8)
    return [
        ("tophat_ellipse", *tophat(r, f.tophat_r)),
        ("tophat_riders", *tophat(b, f.tophat_b)),
        ("tophat_riders", *threshold(r_feat, f.ksize_r, f.C_r, -1)),
        ("tophat_riders", *threshold(b, f.ksize_noise, f.C_noise,
                                     f.noise_thresh)),
        ("thr_merge_open", *threshold(b_feat, f.ksize_b, f.C_b, -1)),
        ("thr_merge_open", *tail(f.open_k, merge=(r_th, b_th, keep))),
        ("thr_merge_open", *tail(f.open_k, merged=merged3)),
        ("merge_open", *tail(f2.open_k, merged=merged5)),
        ("merge_open", *tail(f2.open_k, merge=(r_am, b_am, None))),
        ("adaptive_mean", *adaptive(r, f2.ksize_r, -f2.C_r)),
        ("adaptive_mean", *adaptive(b, f2.ksize_b, -f2.C_b)),
        ("channel_stage", *fused("R", r, f.tophat_r, f.ksize_r, f.C_r)),
        ("channel_stage", *fused("B", b, f.tophat_b, f.ksize_b, f.C_b,
                                 noise)),
        ("channel_stage_pyr", *fused("R", r, f.tophat_r, f.ksize_r, f.C_r)),
    ]


def filter_parity(r, b, f, f2):
    """The five filter wrappers of the main path (attempt 1's three, the
    fallback's adaptive mean and merge + open, with and without the keep
    mask) against their plain twins on (T, H, W) channels r, b: ({wrapper:
    [(mismatches, max abs) of each output]}, the intermediates (r_feat,
    riders, b_feat, r_th, keep, am_args, r_am, b_am))."""
    from lane_tracker_tpu_torch.kernels import filter_stage as fs

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
    return errs, (r_feat, riders, b_feat, r_th, keep, am_args, r_am, b_am)


def report_parity(tag, errs, shape):
    """Print and gate {wrapper: [(mismatches, max abs), ...]}: every
    output equal to its twin's.  Returns each wrapper's max abs error."""
    import torch

    torch.cuda.synchronize()
    for name, pairs in errs.items():
        print(f"[{tag}] {name} at {tuple(shape)}: mismatches "
              f"{[n for n, _ in pairs]} (outputs in order), max abs "
              f"{max(m for _, m in pairs)}")
        check(all(n == 0 for n, _ in pairs), f"{name} disagrees with its "
              f"plain twin at {tuple(shape)}")
    return {name: max(m for _, m in pairs) for name, pairs in errs.items()}


@contextlib.contextmanager
def kernels_by_wrapper(names):
    """Under it, each named filter wrapper, where the main path calls it
    (``ops.filters``), adds the kernels its calls launch, by the library's
    own count around each call, to the yielded dict."""
    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.ops import filters

    counts = {}

    def counting(name, fn):
        def call(*args, **kwargs):
            n0 = fs.kernel_launches()
            out = fn(*args, **kwargs)
            counts[name] = counts.get(name, 0) + fs.kernel_launches() - n0
            return out

        return call

    with mock.patch.multiple(filters, **{
            name: counting(name, getattr(filters, name)) for name in names}):
        yield counts


def counted_launches(fn):
    """Kernel launches one call of fn makes, from the filter-stage
    library's own count (each C launcher adds one per kernel it
    launches)."""
    from lane_tracker_tpu_torch.kernels import filter_stage as fs

    n0 = fs.kernel_launches()
    fn()
    return fs.kernel_launches() - n0


def curve_rmse_px(mine, ref, H):
    import numpy as np

    yy = np.arange(H, dtype=float)
    return float(np.sqrt(np.mean(
        (np.polyval(np.asarray(mine, float), yy)
         - np.polyval(np.asarray(ref, float), yy)) ** 2)))


def gate_oracle(tag, out, oracle, H, limit=RMSE_LIMIT_PX):
    """bench.py's quality gate: the validity trace equals the oracle's and
    the curves are within ``limit`` px RMSE of its coefficients on frames
    valid in both.  Returns the largest RMSE."""
    import numpy as np

    T = out.valid.shape[0]
    valid = out.valid.cpu().numpy()
    n_trace_diff = int((valid != oracle["valid"][:T]).sum())
    print(f"[{tag}] valid {int(valid.sum())}/{T}; invalid frames "
          f"{np.flatnonzero(~valid).tolist()}; frames differing from the "
          f"oracle: {n_trace_diff}")
    check(n_trace_diff == 0, f"{tag}: validity trace differs from the oracle")
    left, right = out.left_coeffs.cpu().numpy(), out.right_coeffs.cpu().numpy()
    by_frame = {t: max(curve_rmse_px(left[t], oracle["left"][t], H),
                       curve_rmse_px(right[t], oracle["right"][t], H))
                for t in range(T) if valid[t] and oracle["valid"][t]}
    rs = [curve_rmse_px(mine[t], ref[t], H) for t in by_frame
          for mine, ref in ((left, oracle["left"]), (right, oracle["right"]))]
    rmse_max = max(rs)
    worst = sorted(by_frame, key=by_frame.get, reverse=True)[:3]
    print(f"[{tag}] rmse_px_max vs oracle {rmse_max} (mean "
          f"{float(np.mean(rs))}, limit {limit}); worst frames "
          f"{[(t, by_frame[t]) for t in worst]}")
    check(rmse_max <= limit, f"{tag}: curves too far from the oracle")
    return rmse_max


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


def process_kwargs(cfg):
    """``LaneTracker.process`` keyword arguments of a TrackerConfig."""
    kw = {k: v for k, v in dataclasses.asdict(cfg.filter).items()
          if k not in ("tophat_r", "tophat_b", "open_k")}
    kw.update(dataclasses.asdict(cfg.search))
    kw["n_tries"] = cfg.n_tries
    return kw


def drive_process(tracker, frames, kw):
    """``process`` over frames with diagnostics: (the frames' StepOutputs
    stacked, each frame's transcript lines)."""
    import torch

    outs, lines = [], []
    for frame in frames:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tracker.process(frame, diagnostics=True, **kw)
        lines.append(buf.getvalue().splitlines())
        outs.append(tracker.last_output)
    return type(outs[0])(*(torch.stack(f) for f in zip(*outs))), lines


def curves_rmse_max(a, b, H):
    """The largest RMSE in px over rows 0..H-1 between the curves of two
    (..., 3) coefficient tensors, row by row."""
    import numpy as np

    a = a.reshape(-1, 3).double().cpu().numpy()
    b = b.reshape(-1, 3).double().cpu().numpy()
    return max(curve_rmse_px(x, y, H) for x, y in zip(a, b))


def stream_of(tree, s):
    """Stream s of a NamedTuple with a leading stream axis."""
    return type(tree)(*(None if x is None else x[s] for x in tree))


def gate_stream(tag, s, fo, fst, co, cst, H):
    """The fleet's stream s (outputs fo, final state fst) against its own
    ``chunk_process`` (co, cst): decisions and integer state identical,
    curves within FLEET_CURVE_PX, the overlay within 1 but on a lane
    edge's ramp (EDGE_*).  Returns (curve RMSE max, overlay values
    differing by more than 1)."""
    for name in exact_fields(fo):
        check(bool(torch_equal(getattr(fo, name), getattr(co, name))),
              f"{tag}: stream {s} {name} differs from its chunk_process")
    for name in exact_fields(fst):
        check(bool(torch_equal(getattr(fst, name), getattr(cst, name))),
              f"{tag}: stream {s} state {name} differs from its "
              "chunk_process")
    rmse = max(
        [curves_rmse_max(getattr(fo, n), getattr(co, n), H)
         for n in ("left_coeffs", "right_coeffs", "a1_left_coeffs",
                   "a1_right_coeffs")]
        + [curves_rmse_max(getattr(fst, n), getattr(cst, n), H)
           for n in COEFF_STATE])
    check(rmse <= FLEET_CURVE_PX, f"{tag}: stream {s} curves {rmse} px from "
          "its chunk_process")
    return rmse, gate_overlay(f"{tag}: stream {s}", fo.overlay, co.overlay)


def gate_overlay(tag, a, b):
    """Two overlays of the same frames within the lane-edge contract
    (EDGE_*): returns the values differing by more than 1."""
    d = (a.int() - b.int()).abs()
    far = int((d > 1).sum())
    check(not bool(d[..., 0].any() or d[..., 2].any())
          and far <= EDGE_VALUES_MAX and int(d.max()) <= EDGE_COLUMN_MAX,
          f"{tag}: overlay differs beyond the lane-edge contract ({far} "
          f"values, max {int(d.max())})")
    return far


def gate_close(tag, a, b, H):
    """Two StepOutputs of the same frames, one from the back-half kernel
    and one from the per-frame loop, whose fit sums round in another
    order: every int and bool field equal, the curves (selected and
    attempt 1's) within FLEET_CURVE_PX RMSE on the frames where they were
    detected, the overlays within the lane-edge contract.  Returns (curve
    RMSE max, overlay values differing by more than 1)."""
    for name in exact_fields(a):
        check(bool(torch_equal(getattr(a, name), getattr(b, name))),
              f"{tag}: {name} differs")
    rmse = 0.0
    for names, det in ((("left_coeffs", "right_coeffs"), a.detected),
                       (("a1_left_coeffs", "a1_right_coeffs"),
                        a.a1_detected)):
        if bool(det.any()):
            rmse = max([rmse] + [curves_rmse_max(getattr(a, n)[det],
                                                 getattr(b, n)[det], H)
                                 for n in names])
    check(rmse <= FLEET_CURVE_PX, f"{tag}: curves {rmse} px apart")
    far = (0 if a.overlay is None
           else gate_overlay(tag, a.overlay, b.overlay))
    return rmse, far


def exact_fields(tree):
    """The fields of a StepOutput or TrackerState held exactly: those of an
    integer or bool dtype (decisions, counts, integer state), the overlay
    aside."""
    return [name for name, x in zip(tree._fields, tree)
            if x is not None and name != "overlay"
            and not x.is_floating_point()]


def torch_equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a, b)


def traced(fn):
    """fn() under torch.profiler: (the trace's events, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace = REPO / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    return events, wall_ms


def print_stages(tag, what, events, wall_ms, reps, card):
    """A trace's idle share and its ``lt.*`` ranges per rep, through
    scripts/torch_chunk_breakdown.py's reader with the fallback's range
    added (that script's stills chunks never open it)."""
    breakdown = importlib.import_module("scripts.torch_chunk_breakdown")
    with mock.patch.object(breakdown, "STAGES",
                           breakdown.STAGES + ("lt.second_attempt",)):
        stages = breakdown.stage_table(events, reps)
    wall_ms /= reps
    busy = sum(v["device_ms"] for v in stages.values())
    in_ranges = sum(v["host_ms"] for v in stages.values())
    print(f"[{tag}] {what} under torch.profiler, per rep over {reps}: wall "
          f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall_ms:.3f}, host outside the lt.* ranges "
          f"{wall_ms - in_ranges:.3f} ms ({card})")
    for name, v in stages.items():
        print(f"[{tag}]   {name:18s} host {v['host_ms']:10.3f} ms  "
              f"device {v['device_ms']:9.3f} ms  launches "
              f"{v['launches']:7.1f}")


def trace_launches(fn, reps):
    """(kernel launch calls, kernels) per rep of fn under torch.profiler:
    the runtime's launch records (cudaLaunchKernel and kin) and the
    device's kernel records."""
    events, _ = traced(fn)
    calls = sum(1 for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", ""))
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    return calls / reps, kernels / reps


def fleet_loads(stills):
    """scripts/fleet_bench.py's loads: FLEET_S streams of FLEET_T frames,
    stream s the stills cycled from offset s, as numpy arrays by name."""
    import numpy as np

    base = np.stack([stills[(s + np.arange(FLEET_T)) % len(stills)]
                     for s in range(FLEET_S)])
    loads = {name: base.copy() for name in FLEET_LOADS}
    loads["fail16"][0, ::FAIL_EVERY] = 0
    loads["fail16_all"][:, ::FAIL_EVERY] = 0
    loads["dead_stream"][0] = 0
    return loads


def fleet_phase(stills, oracles, build_params, cfg, card):
    """Phase 13: ``StreamFleet`` built with no device list, demo1 'fast',
    FLEET_S streams of FLEET_T frames, overlay on, on fleet_bench's four
    loads.  Returns ({(schedule, load) gate step: {wrapper: (calls, kernels
    launched)}}, each wrapper's max abs error against its twin on the
    fleet's batch)."""
    import gc

    import numpy as np
    import torch

    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.parallel import StreamFleet, chunk_process
    from lane_tracker_tpu_torch.tracker.config import SECOND_ATTEMPT
    from lane_tracker_tpu_torch.tracker.step import (
        make_initial_state,
        warp_channels,
    )

    t_phase = time.perf_counter()
    S, T = FLEET_S, FLEET_T
    gp = build_params(FLEET_PIPELINE)
    H = gp.warped_size[1]
    loads = fleet_loads(stills)
    gloads = {name: torch.from_numpy(x).cuda() for name, x in loads.items()}
    print(f"[fleet] demo1 '{FLEET_PIPELINE}', S={S} streams x T={T} frames "
          f"({S * T} a step), overlay on; loads {list(FLEET_LOADS)}; stream "
          f"s the stills cycled from offset s")

    def new_fleet(schedule):
        return StreamFleet(gp, cfg, S, with_overlay=True,
                           second_attempt=schedule)

    def fresh_chunk(frames):
        return chunk_process(make_initial_state(cfg, gp.warped_size, "cuda"),
                             frames, gp, cfg, with_overlay=True,
                             second_attempt="hoist")

    def metric_ints(metrics):
        return {k: int(v) for k, v in metrics.items()}

    def counted_step(fleet, frames):
        """fleet.step(frames): (outs, metrics, {wrapper: (calls, kernels
        launched)}, the library's count over the whole step)."""
        fs.reset_launches()
        n0 = fs.kernel_launches()
        with kernels_by_wrapper(list(FLEET_KERNELS)
                                + list(SECOND_ATTEMPT_LAUNCHES)) as kernels:
            outs, metrics = fleet.step(frames)
        torch.cuda.synchronize()
        n_step = fs.kernel_launches() - n0
        got = {k: (v, kernels.get(k, 0)) for k, v in fs.LAUNCHES.items()
               if v or kernels.get(k)}
        return outs, metrics, got, n_step

    def gate_launches(tag, got, n_step, fallback):
        """Attempt 1's wrappers called once and their kernels launched as
        FLEET_KERNELS, the fallback's as SECOND_ATTEMPT_LAUNCHES exactly
        when it ran, and every kernel of the step launched by one of
        them."""
        want = {k: (1, n) for k, n in FLEET_KERNELS.items()}
        if fallback:
            want.update({k: (n, n)
                         for k, n in SECOND_ATTEMPT_LAUNCHES.items()})
        print(f"[fleet] {tag}: (wrapper calls, kernels launched) {got}; "
              f"kernels in the step {n_step}")
        check(got == want and n_step == sum(n for _, n in want.values()),
              f"fleet {tag}: (wrapper calls, kernels launched) {got} and "
              f"{n_step} in the step, expected {want}")

    # The five filter wrappers against their twins on one load's flat
    # S * T channels: the batch the fleet launches them on.
    flat = gloads["all_valid"].reshape((S * T,) + loads["all_valid"].shape[2:])
    r, b = warp_channels(flat, gp)
    errs, parts = filter_parity(r, b, cfg.filter, SECOND_ATTEMPT.filter)
    fleet_err = report_parity("fleet-parity", errs, r.shape)
    del flat, r, b, errs, parts

    probe = new_fleet("two_phase")
    on_card = all(x.is_cuda for shard in probe.states for x in shard)
    print(f"[fleet] StreamFleet with no device list: mesh {probe.mesh}, "
          f"states on the card {on_card}")
    check(on_card and probe.mesh == (torch.device("cuda", 0),),
          "StreamFleet without a device list is not on the card")
    del probe

    # Gates: each schedule's first step on each load, from fresh states.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fleet_launches, fleets, outs_of, valid_fraction = {}, {}, {}, {}
    for load in FLEET_LOADS:
        first = {}
        for schedule in FLEET_SCHEDULES:
            fleet = fleets[schedule, load] = new_fleet(schedule)
            outs, metrics, got, n_step = counted_step(fleet, gloads[load])
            fleet_launches[f"{schedule} {load}"] = got
            gate_launches(f"{load} {schedule}", got, n_step,
                          schedule == "hoist"
                          or not bool(outs.a1_valid.all()))
            print(f"[fleet] {load} {schedule}: metrics "
                  f"{metric_ints(metrics)}")
            first[schedule] = (outs, metrics)
        outs, metrics = outs_of[load] = first["two_phase"]
        for schedule in FLEET_SCHEDULES[1:]:
            o, m = first[schedule]
            diff = [n for n in outs._fields
                    if not torch_equal(getattr(o, n), getattr(outs, n))]
            check(not diff and metric_ints(m) == metric_ints(metrics),
                  f"fleet {load}: '{schedule}' differs from two_phase in "
                  f"{diff} or its metrics")
        sums = {"frames": outs.valid.numel(),
                "valid_frames": int(outs.valid.sum()),
                "detected_frames": int(outs.detected.sum()),
                "second_attempts": int((outs.n_attempts > 1).sum())}
        check(all(v.dtype == torch.int32 for v in metrics.values())
              and metric_ints(metrics) == sums and sums["frames"] == S * T,
              f"fleet {load}: metrics {metric_ints(metrics)} are not the "
              f"outputs' sums {sums}")
        valid_fraction[load] = sums["valid_frames"] / sums["frames"]
        check(tuple(outs.overlay.shape) == (S, T, 720, 1280, 3)
              and bool(torch.isfinite(outs.left_coeffs).all()),
              f"fleet {load}: overlay shape or non-finite coefficients")
        states = fleets["two_phase", load].states[0]
        rmse_max, far_total = 0.0, 0
        for s in range(S):
            cst, co = fresh_chunk(gloads[load][s])
            rmse, far = gate_stream(f"fleet {load}", s, stream_of(outs, s),
                                    stream_of(states, s), co, cst, H)
            rmse_max, far_total = max(rmse_max, rmse), far_total + far
        print(f"[fleet] {load}: the three schedules identical; each of the "
              f"{S} streams equals its own chunk_process (hoist, fresh "
              f"state): curves within {rmse_max} px, overlay values off by "
              f"more than 1: {far_total}; metrics the outputs' sums; "
              f"valid_fraction {valid_fraction[load]}")
        if load == "all_valid":
            gate_oracle("fleet all_valid stream 0", stream_of(outs, 0),
                        oracles["bench_oracle"], H)
        elif load == "fail16":
            gate_oracle("fleet fail16 stream 0", stream_of(outs, 0),
                        oracles[f"bench_oracle_fail{FAIL_EVERY}"], H)
        elif load == "dead_stream":
            det = outs.detected
            check(not bool(det[0].any()) and bool(det[1:].all()),
                  "fleet dead_stream: stream 0 detected, or another did not")
            print("[fleet] dead_stream: stream 0 detects nothing, the "
                  "others every frame")
    # One stream: the same kernel launches a step as eight.
    one = StreamFleet(gp, cfg, 1, with_overlay=True)
    outs, _, got, n_step = counted_step(one, gloads["fail16"][:1])
    gate_launches("fail16 stream 0 alone (S=1) two_phase", got, n_step,
                  True)
    del one
    peak = torch.cuda.max_memory_allocated()
    print(f"[fleet] peak device memory over the gate steps "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated; {card})")

    # 'auto' on dead_stream: the schedule after each step equals a host
    # replay of the EMA rule on the observed indicators.
    auto = new_fleet("auto")
    ema, sched, seen = 0.0, "two_phase", []
    for _ in range(FLEET_AUTO_STEPS):
        outs, _ = auto.step(gloads["dead_stream"])
        ema += 0.25 * (float(not bool(outs.a1_valid.all())) - ema)
        if sched == "two_phase" and ema > 0.81:
            sched = "hoist"
        elif sched == "hoist" and ema < 0.81 - 0.05:
            sched = "two_phase"
        seen.append(auto.schedule)
        check(auto.schedule == sched and abs(auto.poison_ema - ema) < 1e-12,
              f"auto: schedule {auto.schedule} / EMA {auto.poison_ema}, "
              f"the replay {sched} / {ema}")
    print(f"[fleet] auto on dead_stream, {FLEET_AUTO_STEPS} steps: schedules "
          f"{seen}, EMA {auto.poison_ema}")
    check(auto.schedule == "hoist",
          "auto did not resolve to hoist on dead_stream")

    # The CPU path: the first frames of streams 0-1 of fail16.
    cs, ct = FLEET_CPU
    cpu_fleet = StreamFleet(build_params(FLEET_PIPELINE, device="cpu"), cfg,
                            cs, mesh=("cpu",), with_overlay=True)
    t0 = time.perf_counter()
    cpu_outs, _ = cpu_fleet.step(loads["fail16"][:cs, :ct])
    gout = outs_of["fail16"][0]
    for name in exact_fields(gout):
        check(torch_equal(getattr(gout, name)[:cs, :ct].cpu(),
                          getattr(cpu_outs, name)),
              f"fleet: the CPU path's {name} differs from the card's")
    rmse = curves_rmse_max(gout.left_coeffs[:cs, :ct], cpu_outs.left_coeffs,
                           H)
    print(f"[fleet] CPU path (devices ('cpu',), S={cs}, T={ct}, fail16): "
          f"{time.perf_counter() - t0:.1f} s; decisions equal the card's, "
          f"left curves within {rmse} px")
    del cpu_fleet, cpu_outs, gout

    # Aggregate frames/s: each schedule in turns on each load, states
    # carried on from the gate step (the warm-up), by CUDA events.
    times = {key: [] for key in fleets}
    for _ in range(FLEET_TIMED_STEPS):
        for key, fleet in fleets.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fleet.step(gloads[key[1]])
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    for (schedule, load), ts in times.items():
        med = float(np.median(ts))
        resolved = fleets[schedule, load].schedule
        print(f"[fleet-timing] {load} {schedule}"
              + (f" (now {resolved})" if schedule == "auto" else "")
              + f": {S * T * 1000.0 / med:.1f} frames/s, {med / (S * T):.4f} "
              f"ms a frame; step ms median {med:.3f} of {len(ts)} after a "
              f"warm-up (min {min(ts):.3f}, max {max(ts):.3f}); "
              f"valid_fraction {valid_fraction[load]} ({card})")
    ts = []
    for _ in range(FLEET_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        auto.step(gloads["dead_stream"])
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    med = float(np.median(ts))
    print(f"[fleet-timing] dead_stream auto after {FLEET_AUTO_STEPS} steps "
          f"({auto.schedule}): {S * T * 1000.0 / med:.1f} frames/s, step ms "
          f"median {med:.3f} (min {min(ts):.3f}, max {max(ts):.3f}) ({card})")
    # Release the phase's memory: the later phases' timings start from
    # the caching allocator's pool as it was before the phase.
    del fleets, fleet, auto, first, outs_of, outs, states, gloads, o, m
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[fleet] phase 13 took {time.perf_counter() - t_phase:.1f} s "
          f"({FLEET_TIMED_STEPS} timed steps a schedule and load, "
          f"{FLEET_AUTO_STEPS} auto steps); after it the caching allocator "
          f"holds {torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    return fleet_launches, fleet_err


def fleet_profile(stills, build_params, cfg, card):
    """Phase 13's measurements under torch.profiler, run after phase 10's
    timings: once a process has traced the card, its later launches pay
    more on the host, so no profiler runs before a timing.  Gated: the
    back half's launches per time step at S=FLEET_S at most twice those
    at S=1."""
    import torch

    from lane_tracker_tpu_torch.parallel import StreamFleet
    from lane_tracker_tpu_torch.parallel.mesh import map_tensors
    from lane_tracker_tpu_torch.parallel.streams import scan_streams
    from lane_tracker_tpu_torch.tracker.state import TrackerState
    from lane_tracker_tpu_torch.tracker.step import (
        front_artifacts_batch,
        make_initial_state,
    )

    S = FLEET_S
    gp = build_params(FLEET_PIPELINE)
    fail16 = torch.from_numpy(fleet_loads(stills)["fail16"]).cuda()

    def new_fleet(schedule):
        return StreamFleet(gp, cfg, S, with_overlay=True,
                           second_attempt=schedule)

    # The back half's launches per time step at S=1 and S=FLEET_S, on
    # fail16's hoisted artifacts.
    per_step = {}
    for n in (1, S):
        flat = fail16[:n, :FLEET_LAUNCH_T].reshape(
            (n * FLEET_LAUNCH_T,) + fail16.shape[2:])
        arts = map_tensors(
            lambda x, n=n: x.reshape((n, FLEET_LAUNCH_T) + x.shape[1:]),
            front_artifacts_batch(flat, gp, cfg, hoist_second_attempt=True))
        st = TrackerState(*(x.expand(n, *x.shape).contiguous()
                            for x in make_initial_state(cfg, gp.warped_size,
                                                        "cuda")))
        scan_streams(st, arts, gp, cfg)  # warm-up
        per_step[n] = trace_launches(lambda: scan_streams(st, arts, gp, cfg),
                                     FLEET_LAUNCH_T)
    print(f"[fleet] back half launches per time step (launch calls, "
          f"kernels; hoist, {FLEET_LAUNCH_T} steps under torch.profiler): "
          f"S=1 {per_step[1]}, S={S} {per_step[S]}")
    check(per_step[S][0] <= 2 * per_step[1][0],
          "the batched back half's launches grow with the streams")

    # One fail16 two_phase step under the profiler, read through its lt.*
    # ranges.
    fleet = new_fleet("two_phase")
    fleet.step(fail16)
    events, wall_ms = traced(lambda: fleet.step(fail16))
    print_stages("fleet-profile", "fail16 two_phase step", events, wall_ms,
                 1, card)


def gaps_phase(stills, oracles, build_params, cfg, card):
    """Phase 14: the motion frames made on the card, the main path at the
    bench's T_BENCH frames on the stills, fail16 and motion chunks against
    every frame of their oracles.  Releases its memory at the end."""
    import gc

    import numpy as np
    import torch

    from lane_tracker_tpu_torch.io import motion
    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.parallel import chunk_process
    from lane_tracker_tpu_torch.tracker.step import make_initial_state

    t_phase = time.perf_counter()
    gp = build_params("corridor")
    H = gp.warped_size[1]

    def fresh():
        return make_initial_state(cfg, gp.warped_size, "cuda")

    # The motion frames: made on the card, held to the CPU generator.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gmotion = motion.motion_chunk(T_BENCH)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    scenes = motion.load_scenes("cpu")
    diffs = {t: mismatches(gmotion[t].cpu(), motion.motion_frame(t, scenes))[0]
             for t in MOTION_SAMPLED}
    print(f"[gaps] motion_chunk({T_BENCH}) on the card: "
          f"{tuple(gmotion.shape)} {gmotion.dtype} in {gen_s:.2f} s; values "
          f"differing from the CPU generator at t {diffs} ({card})")
    check(gmotion.is_cuda and not any(diffs.values()),
          "the card's motion frames differ from the CPU generator's")

    # The main path at the bench's chunk size, from a fresh state.
    idx = np.arange(T_BENCH) % len(stills)
    gstills = torch.from_numpy(stills[idx]).cuda()
    gfail = gstills.clone()
    gfail[::FAIL_EVERY] = 0
    with np.load(REPO / "assets" / "bench_oracle_motion.npz") as z:
        motion_oracle = {k: z[k] for k in ("valid", "left", "right")}
    runs = (("stills", gstills, oracles["bench_oracle"], RMSE_LIMIT_PX),
            (f"fail{FAIL_EVERY}", gfail,
             oracles[f"bench_oracle_fail{FAIL_EVERY}"], RMSE_LIMIT_PX),
            ("motion", gmotion, motion_oracle, MOTION_RMSE_LIMIT_PX))
    for tag, frames, oracle, limit in runs:
        check(len(oracle["valid"]) >= T_BENCH,
              f"{tag}: the oracle covers fewer than {T_BENCH} frames")
        params, pipeline = gp, "corridor"
        while True:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fs.reset_launches()
            t0 = time.perf_counter()
            _, out = chunk_process(fresh(), frames, params, cfg,
                                   with_overlay=True,
                                   second_attempt="two_phase")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1000.0
            peak = torch.cuda.max_memory_allocated()
            got = {k: n for k, n in fs.LAUNCHES.items() if n}
            ok = out.corridor_ok.cpu().numpy()
            print(f"[gaps] {tag} chunk_process T={T_BENCH} ('{pipeline}', "
                  f"two_phase, overlay on, fresh state): {ms:.1f} ms a chunk "
                  f"(one run, not a timing claim); peak device memory "
                  f"{peak / 2**30:.3f} GiB (max_memory_allocated); launches "
                  f"{got}; corridor_ok {int(ok.sum())}/{T_BENCH} ({card})")
            if ok.all() or pipeline == "fast":
                break
            print(f"[gaps] {tag}: corridor certificate failed on "
                  f"{int((~ok).sum())} frames; rerunning in the full-width "
                  "'fast' pipeline (bench.py's rule) and gating that run")
            params, pipeline = build_params("fast"), "fast"
        check(tuple(out.overlay.shape) == (T_BENCH, 720, 1280, 3),
              f"{tag}: overlay shape")
        check(all(got.get(name) for name in ATTEMPT1),
              f"{tag}: an attempt-1 kernel did not launch")
        fallback = not bool(out.a1_valid.all())
        check(all(got.get(name, 0) == (n if fallback else 0)
                  for name, n in SECOND_ATTEMPT_LAUNCHES.items()),
              f"{tag}: the fallback's launches do not match its schedule")
        rmse = gate_oracle(f"gaps {tag} T={T_BENCH}", out, oracle, H, limit)
        print(f"[gaps] {tag} T={T_BENCH}: trace equal to the oracle on all "
              f"{T_BENCH} frames, rmse_px_max {rmse} (limit {limit}) "
              f"({card})")
        del out

    # Release the phase's memory, as phase 13 does.
    del gmotion, gstills, gfail, runs, frames, gp
    del params, fresh  # they hold gp
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[gaps] phase 14 took {time.perf_counter() - t_phase:.1f} s; "
          f"after it the caching allocator holds "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB ({card})")


def rescale_coeffs(coeffs, s):
    """x(y) coefficients fitted in an s-times-downscaled warped space in
    full-resolution warped coordinates (copied from
    scripts/approx_quality.py:28-42): a full-resolution u is the downscaled
    (u - d) / s, d = (s - 1) / 2, so x_f(y_f) = s * x_h((y_f - d) / s) + d."""
    import numpy as np

    c2, c1, c0 = (float(c) for c in coeffs)
    d = (s - 1) / 2.0
    return np.array([s * c2 / (s * s),
                     s * (c1 / s - 2 * c2 * d / (s * s)),
                     s * (c2 * d * d / (s * s) - c1 * d / s + c0) + d])


def bench_rmse(valid, left, right, oracle, s):
    """(frames whose validity differs from the live reference's oracle,
    rmse_px_max against its curves on frames valid in both) of a trace and
    its (T, 3) coefficients fitted at 1/s of the warped resolution."""
    import numpy as np

    T = len(valid)
    n_diff = int((np.asarray(valid) != oracle["valid"][:T]).sum())
    rs = [curve_rmse_px(rescale_coeffs(mine[t], s) if s != 1 else mine[t],
                        ref[t], 1100)
          for t in range(T) if valid[t] and oracle["valid"][t]
          for mine, ref in ((left, oracle["left"]), (right, oracle["right"]))]
    return n_diff, max(rs)


def frame_ms(fn):
    """Median ms of ``fn(i)`` a call by CUDA events, over N_PROCESS_TIMED
    calls after 4 warm-up calls; (median, min, max)."""
    import numpy as np
    import torch

    for i in range(4):
        fn(i)
    ms = []
    for i in range(N_PROCESS_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms)), min(ms), max(ms)


def modes_phase(stills, oracles, build_params, new_tracker, cfg, card,
                path_launches):
    """Phase 15: the opt-in modes ('turbo', 'half', the latency mode)
    against the JAX package's results and their own CPU path, the five
    filter wrappers at their shapes, and their times.  Adds each path's
    launches to ``path_launches``; releases its memory at the end."""
    import gc

    import numpy as np
    import torch

    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.parallel import chunk_process
    from lane_tracker_tpu_torch.timing import cuda_ms
    from lane_tracker_tpu_torch.tracker.config import halve_config
    from lane_tracker_tpu_torch.tracker.step import (
        _sa_config,
        make_initial_state,
        warp_channels,
    )

    t_phase = time.perf_counter()
    with np.load(REPO / "assets" / "mode_oracle.npz") as z:
        jax_oracle = {k: z[k] for k in z.files}
    chunk = torch.from_numpy(stills[np.arange(T_SLICE) % len(stills)])
    fail = chunk.clone()
    fail[::FAIL_EVERY] = 0
    tag_f = f"fail{FAIL_EVERY}"
    chunks = {"stills": chunk, tag_f: fail}
    bench = {"stills": oracles["bench_oracle"],
             tag_f: oracles[f"bench_oracle_fail{FAIL_EVERY}"]}
    gchunk = chunk.cuda()

    def config_of(pipeline):
        return halve_config(cfg) if pipeline == "half" else cfg

    def fresh(params, pcfg, device="cuda"):
        return make_initial_state(pcfg, params.warped_size, device)

    # ---- (a) 'turbo' and (b) 'half' against the JAX package ----
    for pipeline in MODE_PIPELINES:
        gp, cp = build_params(pipeline), build_params(pipeline, device="cpu")
        pcfg = config_of(pipeline)
        H, s = gp.warped_size[1], gp.res_scale
        # (d) The five filter wrappers at this pipeline's channels, its
        # config's sizes and its second attempt's.
        r, b = warp_channels(gchunk, gp)
        errs, _ = filter_parity(r, b, pcfg.filter, _sa_config(gp).filter)
        report_parity(f"modes {pipeline}", errs, r.shape)
        del r, b, errs
        for tag, frames in chunks.items():
            g = frames.cuda()
            fs.reset_launches()
            _, out = chunk_process(fresh(gp, pcfg), g, gp, pcfg,
                                   with_overlay=True,
                                   second_attempt="two_phase")
            torch.cuda.synchronize()
            got = {k: n for k, n in fs.LAUNCHES.items() if n}
            path_launches[f"{pipeline} {tag}"] = got
            print(f"[modes] '{pipeline}' chunk_process T={T_SLICE} on "
                  f"{tag} (two_phase, overlay on, fresh state; warped "
                  f"{gp.warped_size}): launches {got}")
            check(all(got.get(name) for name in ATTEMPT1),
                  f"{pipeline} {tag}: an attempt-1 kernel did not launch")
            fallback = not bool(out.a1_valid.all())
            check(all(got.get(name, 0) == (n if fallback else 0)
                      for name, n in SECOND_ATTEMPT_LAUNCHES.items()),
                  f"{pipeline} {tag}: the fallback's launches do not "
                  "match its schedule")
            check(tuple(out.overlay.shape) == (T_SLICE, 720, 1280, 3),
                  f"{pipeline} {tag}: overlay shape")
            key = f"{pipeline}_{tag}"
            joracle = {k: jax_oracle[f"{key}_{k}"]
                       for k in ("valid", "left", "right")}
            rmse_jax = gate_oracle(f"modes {pipeline} {tag} vs JAX", out,
                                   joracle, H, MODE_RMSE_LIMIT_PX)
            valid = out.valid.cpu().numpy()
            n_mine, r_mine = bench_rmse(valid, out.left_coeffs.cpu().numpy(),
                                        out.right_coeffs.cpu().numpy(),
                                        bench[tag], s)
            n_jax, r_jax = bench_rmse(joracle["valid"], joracle["left"],
                                      joracle["right"], bench[tag], s)
            print(f"[modes] '{pipeline}' {tag}: validity trace equal to "
                  f"JAX's on all {T_SLICE} frames, curves {rmse_jax} px "
                  f"from JAX's (limit {MODE_RMSE_LIMIT_PX}); against the "
                  f"live reference's oracle (not gated): frames differing "
                  f"{n_mine} (JAX {n_jax}), rmse_px_max {r_mine} (JAX's own "
                  f"{r_jax}) ({card})")
            # The card's first T_CPU frames against the CPU path, state
            # included.
            cpu_frames = frames[:T_CPU]
            c_state, c_out = chunk_process(fresh(cp, pcfg, "cpu"), cpu_frames,
                                           cp, pcfg, with_overlay=True,
                                           second_attempt="two_phase")
            g_state, g_out = chunk_process(fresh(gp, pcfg), g[:T_CPU], gp,
                                           pcfg, with_overlay=True,
                                           second_attempt="two_phase")
            compare_cpu(f"modes {pipeline} {tag}", out, c_out)
            for tree, ctree in ((g_out, c_out), (g_state, c_state)):
                for name in exact_fields(tree):
                    check(torch_equal(getattr(tree, name).cpu(),
                                      getattr(ctree, name)),
                          f"{pipeline} {tag}: card and CPU differ in {name}")
            rmse_cpu = max(
                [curves_rmse_max(getattr(out, n)[:T_CPU], getattr(c_out, n),
                                 H)
                 for n in ("left_coeffs", "right_coeffs")]
                + [curves_rmse_max(getattr(g_state, n), getattr(c_state, n),
                                   H) for n in COEFF_STATE])
            print(f"[modes] '{pipeline}' {tag}: card vs CPU on {T_CPU} "
                  f"frames: decisions and integer state equal, curves "
                  f"{rmse_cpu} px apart")
            check(rmse_cpu <= MODE_RMSE_LIMIT_PX,
                  f"{pipeline} {tag}: card and CPU curves too far apart")
            del out, g, g_out, g_state
        del gp, cp

    # ---- (c) The latency mode ----
    kw = process_kwargs(cfg)
    frames8 = stills[np.arange(N_PROCESS) % len(stills)]
    for pipeline in LATENCY_PIPELINES:
        trackers = {mode: new_tracker(pipeline=pipeline, latency_mode=mode)
                    for mode in (True, False)}
        lp, gp = trackers[True].params, trackers[False].params
        check(lp.mm_und is not None and lp.mm_warp is not None
              and lp.mm_und.onehot.is_cuda,
              f"latency mode ('{pipeline}') built no tile structures on the "
              "card")
        onehot_bytes = (lp.mm_und.onehot.nbytes + lp.mm_warp.onehot.nbytes)
        frame1 = gchunk[:1]
        warps = [warp_channels(frame1, p) for p in (lp, gp)]
        check(all(torch.equal(a, b) for a, b in zip(*warps)),
              f"'{pipeline}': warp_channels at T=1 by rowmm differs from the "
              "gather")
        fs.reset_launches()
        for frame in frames8:
            annotated = {mode: t.process(frame, **kw)
                         for mode, t in trackers.items()}
            a, b = (trackers[m].last_output for m in (True, False))
            diff = [n for n in a._fields if not torch_equal(getattr(a, n),
                                                            getattr(b, n))]
            check(not diff and np.array_equal(annotated[True],
                                              annotated[False]),
                  f"'{pipeline}' latency mode differs from the gather in "
                  f"{diff or 'the annotated frame'}")
        torch.cuda.synchronize()
        path_launches[f"latency {pipeline}"] = {
            k: n for k, n in fs.LAUNCHES.items() if n}
        warp_t = {mode: frame_ms(lambda i, p=p: warp_channels(
            gchunk[i % T_SLICE:i % T_SLICE + 1], p))
            for mode, p in ((True, lp), (False, gp))}
        proc_t = {mode: frame_ms(lambda i, t=t: t.process(
            frames8[i % N_PROCESS], **kw))
            for mode, t in trackers.items()}
        print(f"[modes] latency mode '{pipeline}': {N_PROCESS} frames of "
              f"process (both trackers 2 x {N_PROCESS} launches "
              f"{path_launches[f'latency {pipeline}']}) equal to the gather's "
              f"in every output and annotated frame; warp_channels at T=1 "
              f"bit for bit; one-hot tensors {onehot_bytes / 2**20:.1f} MiB "
              f"(bf16); warp_channels ms a frame, rowmm {warp_t[True]} / "
              f"gather {warp_t[False]}; process ms a frame, rowmm "
              f"{proc_t[True]} / gather {proc_t[False]} (median, min, max of "
              f"{N_PROCESS_TIMED} after 4 warm-up, CUDA events) ({card})")
        del trackers, lp, gp, warps

    # ---- (e) Times, 'fast', 'turbo' and 'half' in turns (no claim) ----
    timed = {p: (build_params(p), config_of(p)) for p in TIMED_PIPELINES}
    peaks, times = {}, {}
    for pipeline in TIMED_PIPELINES + TIMED_PIPELINES[::-1]:
        params, pcfg = timed[pipeline]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st, _ = chunk_process(fresh(params, pcfg), gchunk, params, pcfg,
                              second_attempt="two_phase")
        torch.cuda.synchronize()
        peaks.setdefault(pipeline, []).append(
            torch.cuda.max_memory_allocated() / 2**30)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(MODE_TIMED_CHUNKS):
            st, _ = chunk_process(st, gchunk, params, pcfg,
                                  second_attempt="two_phase")
        end.record()
        torch.cuda.synchronize()
        chunk_t = start.elapsed_time(end) / MODE_TIMED_CHUNKS
        warp_t = cuda_ms(lambda: warp_channels(gchunk, params), 3)
        times.setdefault(pipeline, []).append((chunk_t, warp_t))
    for pipeline, ts in times.items():
        print(f"[modes] '{pipeline}' stills T={T_SLICE} (two_phase, state "
              f"carried): chunk ms {[round(c, 3) for c, _ in ts]}, "
              f"warp_channels (lt.warp_lab's work) ms a chunk "
              f"{[round(w, 3) for _, w in ts]} (two turns; chunk: mean of "
              f"{MODE_TIMED_CHUNKS} after a warm-up, warp: mean of 3, CUDA "
              f"events), peak device memory "
              f"{[round(p, 3) for p in peaks[pipeline]]} GiB "
              f"(max_memory_allocated, a warm-up chunk) ({card})")

    del timed, gchunk, chunk, fail, chunks, st
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[modes] phase 15 took {time.perf_counter() - t_phase:.1f} s; "
          f"after it the caching allocator holds "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB ({card})")


def run_entry(tag, argv, env):
    """``python <argv>`` from the repository's root with ``env`` over the
    environment (no other BENCH_, LATENCY_ or FLEET_ variable); prints
    every line it wrote, and returns its stdout's lines parsed as JSON."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(ENTRY_ENV)}
    full.update(env)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *argv], cwd=REPO, env=full,
                         capture_output=True, text=True,
                         timeout=ENTRY_TIMEOUT_S)
    print(f"[bench] {tag}: {' '.join(f'{k}={v}' for k, v in env.items())} "
          f"python {' '.join(argv)}: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in res.stderr.splitlines():
        print(f"[bench] {tag} (stderr) {line}")
    for line in res.stdout.splitlines():
        print(f"[bench] {tag} {line}")
    check(res.returncode == 0, f"{tag} exited {res.returncode}")
    return [json.loads(line) for line in res.stdout.splitlines()]


def bench_phase(kind, card, oracles, path_launches):
    """Phase 16: bench_torch.py's three variants, the latency sweep and
    the fleet bench, each run as a user runs it, in a process of its own
    that reuses the kernels built in build/.  Adds each bench variant's
    first-chunk launches to ``path_launches``."""
    import numpy as np

    t_phase = time.perf_counter()
    with np.load(REPO / "assets" / "bench_oracle_motion.npz") as z:
        valid = {"stills": oracles["bench_oracle"]["valid"],
                 "fail16": oracles[f"bench_oracle_fail{FAIL_EVERY}"]["valid"],
                 "motion": z["valid"]}
    for tag, env, limit in BENCH_VARIANTS:
        *_, launches, line = run_entry(tag, ["bench_torch.py"], env)
        where = f"bench_torch.py {tag}"
        check(line["device"]["name"] == kind and line["device"]["power_limit"],
              f"{where}: the line does not name the card and its limit")
        check(line["chunk_size"] == T_BENCH and line["bench_variant"] == tag,
              f"{where}: chunk_size or bench_variant")
        check(line["certified_exact"] or line["pipeline"] == "fast",
              f"{where}: neither certified nor the recorded 'fast' fallback")
        check(line["rmse_gate_frames"] == T_BENCH
              and line["rmse_px_max"] <= limit,
              f"{where}: rmse_px_max {line['rmse_px_max']} over "
              f"{line['rmse_gate_frames']} frames (limit {limit})")
        check(line["valid_fraction"] == float(valid[tag][:T_BENCH].mean()),
              f"{where}: valid_fraction differs from the oracle's")
        check(line["value"] > 0 and line["timed_chunks"] > 0
              and "vs_baseline" not in line
              and "vs_target_2000fps" not in line,
              f"{where}: no timing, or a TPU ratio")
        fallback = tag != "stills"
        for part, got in launches["launches"].items():
            check(all(got.get(name) for name in ATTEMPT1)
                  and all(bool(got.get(name)) == fallback
                          for name in SECOND_ATTEMPT_LAUNCHES),
                  f"{where}: {part} launched {got}")
        path_launches[f"bench {tag}"] = launches["launches"]["first_chunk"]
        print(f"[bench] {where}: {line['value']:.3f} frames/s, chunk ms "
              f"median {line['chunk_ms_median']:.3f} (min "
              f"{line['chunk_ms_min']:.3f}, max {line['chunk_ms_max']:.3f}; "
              f"wall median {line['wall_ms_median']:.3f}) over "
              f"{line['timed_chunks']} chunks; rmse_px_max "
              f"{line['rmse_px_max']}; peak {line['peak_mem_gib']} GiB "
              f"({card})")
    rows = run_entry("latency", ["scripts/torch_latency_bench.py",
                                 *LATENCY_ARGS], {})
    check([(r["pipeline"], r["chunk"]) for r in rows]
          == [(p, int(t)) for p in ("corridor", "fast") for t in LATENCY_ARGS]
          and all(all(k in r for k in LATENCY_KEYS) and r["fps"] > 0
                  and r["device"]["name"] == kind for r in rows),
          "the latency sweep's rows")
    argv, env = FLEET_BENCH
    rows = run_entry("fleet", ["scripts/torch_fleet_bench.py", *argv], env)
    check([(r["schedule"], r["load"]) for r in rows]
          == [(s, env["FLEET_LOADS"]) for s in FLEET_SCHEDULES]
          and all(all(k in r for k in FLEET_KEYS) and r["aggregate_fps"] > 0
                  and r["device"]["name"] == kind
                  and (r["streams"], r["chunk"]) == tuple(map(int, argv))
                  for r in rows)
          and "resolved_schedule" in rows[-1]
          and len({r["valid_fraction"] for r in rows}) == 1
          and 0 < rows[0]["valid_fraction"] < 1, "the fleet bench's rows")
    print(f"[bench] phase 16 took {time.perf_counter() - t_phase:.1f} s "
          f"({card})")


def back_half_work(S, T, H, attempts):
    """Bytes one scan must move: per row, side and attempt the two prefix
    words it gathers and the blind interval's ends and flag; the two
    graphs written a frame."""
    return S * T * (attempts * H * 2 * (2 * 4 + 4 + 4 + 1) + 2 * H * 4)


def back_half_phase(build_params, cfg, card):
    """Phase 17: the back-half kernel against its plain twins on the main
    path's shapes, and its times.  Returns the kernels line's row parts:
    (cases, largest curve or graph gap in px).  Releases its memory."""
    import gc

    import numpy as np
    import torch

    from lane_tracker_tpu_torch.io.motion import motion_chunk
    from lane_tracker_tpu_torch.kernels import back_half as bhk
    from lane_tracker_tpu_torch.kernels.filter_stage import kernel_launches
    from lane_tracker_tpu_torch.parallel.pipeline import (
        scan_back_half,
        scan_back_half_plain,
    )
    from lane_tracker_tpu_torch.parallel.streams import scan_streams_plain
    from lane_tracker_tpu_torch.timing import cuda_ms, queued_ms
    from lane_tracker_tpu_torch.tracker.state import TrackerState
    from lane_tracker_tpu_torch.tracker.step import (
        FrontArtifacts,
        front_artifacts_batch,
        make_initial_state,
    )

    t_phase = time.perf_counter()
    params = build_params("fast")
    H = params.warped_size[1]
    frames = motion_chunk(T_BENCH, "cuda")
    parts = [front_artifacts_batch(frames[i:i + 128], params, cfg,
                                   hoist_second_attempt=True)
             ._replace(r_chan=None, b_chan=None)
             for i in range(0, T_BENCH, 128)]
    del frames

    def cat(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs)
        return type(xs[0])(*(cat(f) for f in zip(*xs)))

    arts2 = FrontArtifacts(*(cat(xs) for xs in zip(*parts)))
    del parts
    arts1 = arts2._replace(pref2=None, iv_sws2=None)
    S, T = BACK_HALF_STREAMS

    def streams(arts):
        return FrontArtifacts(*(
            None if x is None else
            (x.reshape(S, T, *x.shape[1:]) if isinstance(x, torch.Tensor)
             else type(x)(*(f.reshape(S, T, *f.shape[1:]) for f in x)))
            for x in arts))

    state = make_initial_state(cfg, params.warped_size, "cuda")
    states = TrackerState(*(x.expand(S, *x.shape).contiguous()
                            for x in state))

    def gap(a, b):
        a = a.double().cpu().numpy().reshape(-1, 3)
        b = b.double().cpu().numpy().reshape(-1, 3)
        if not len(a):
            return 0.0
        y = np.arange(H, dtype=float)
        d = a - b
        return float(np.abs(d[:, :1] * y * y + d[:, 1:2] * y
                            + d[:, 2:3]).max())

    def compare(tag, kernel, twin):
        """Every int and bool equal; the fits and graphs within
        BACK_HALF_PX.  Returns (curve px, graph px)."""
        (k_st, (k_out, k_meta)), (t_st, (t_out, t_meta)) = kernel, twin
        for tk, tt in ((k_st, t_st), (k_out, t_out), (k_meta, t_meta)):
            for name in exact_fields(tt):
                check(torch_equal(getattr(tk, name), getattr(tt, name)),
                      f"back half {tag}: {name} differs from the twin's")
        det, det1 = k_out.detected, k_out.a1_detected
        curve = max([gap(getattr(k_out, n)[det], getattr(t_out, n)[det])
                     for n in ("left_coeffs", "right_coeffs")]
                    + [gap(getattr(k_out, n)[det1], getattr(t_out, n)[det1])
                       for n in ("a1_left_coeffs", "a1_right_coeffs")]
                    + [gap(getattr(k_st, n), getattr(t_st, n))
                       for n in COEFF_STATE]
                    + [gap(getattr(k_meta, n), getattr(t_meta, n))
                       for n in ("coeffs_left", "coeffs_right")])
        graph = max(float((getattr(k, n) - getattr(t, n)).abs().max())
                    for k, t, names in (
                        (k_meta, t_meta, ("fitx_left", "fitx_right")),
                        (k_st, t_st, ("rfitx_left", "rfitx_right")))
                    for n in names)
        check(curve <= BACK_HALF_PX and graph <= BACK_HALF_PX,
              f"back half {tag}: fits {curve} px, graphs {graph} px from "
              "the twin's")
        return curve, graph, {
            "frames": int(k_out.valid.numel()),
            "valid": int(k_out.valid.sum()),
            "second": int((k_out.n_attempts > 1).sum()),
            "band": int(k_out.search_mode.sum())}

    cases, worst = [], 0.0
    for tag, n_streams, arts, c in (
            (f"one stream T={T_BENCH}, one attempt", 1, arts1,
             cfg.replace(n_tries=1)),
            (f"one stream T={T_BENCH}, two attempts", 1, arts2, cfg),
            (f"{S} streams x {T}, one attempt", S, streams(arts1),
             cfg.replace(n_tries=1)),
            (f"{S} streams x {T}, two attempts", S, streams(arts2), cfg)):
        attempts = 2 if c.n_tries == 2 else 1
        if n_streams == 1:
            def call():
                return scan_back_half(state, arts, params, c)

            def twin():
                return scan_back_half_plain(state, arts, params, c)
        else:
            def call():
                return bhk.scan(states, arts, params, c)

            def twin():
                return scan_streams_plain(states, arts, params, c)
        torch.cuda.synchronize()
        f0, k0 = kernel_launches(), bhk.kernel_launches()
        kernel = call()
        torch.cuda.synchronize()
        n_launch = (kernel_launches() - f0, bhk.kernel_launches() - k0)
        check(n_launch == (0, 1), f"back half {tag}: launches (filter "
              f"stage, back half) {n_launch}, not (0, 1)")
        t0 = time.perf_counter()
        plain = twin()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        curve, graph, seen = compare(tag, kernel, plain)
        del kernel, plain
        ms = queued_ms(call, BACK_HALF_REPS)
        events_ms = cuda_ms(call, BACK_HALF_REPS)
        bound_ms = (back_half_work(n_streams, arts.pref.packed.shape[-3],
                                   H, attempts) / HBM_BYTES_PER_S * 1e3)
        frames_n = n_streams * arts.pref.packed.shape[-3]
        row = {"case": tag, "ms": ms, "events_ms": events_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "ms_per_frame": ms / frames_n,
               "plain_ms_per_frame": plain_ms / frames_n,
               "curve_px": curve, "graph_px": graph, **seen}
        cases.append(row)
        worst = max(worst, curve, graph)
        print(f"[back-half] {tag}: kernel {ms:.3f} ms queued ({events_ms:.3f}"
              f" by events), plain twin {plain_ms:.1f} ms, bound "
              f"{bound_ms:.5f} ms (bytes; latency-bound); against the twin: "
              f"ints and bools equal, fits {curve} px, graphs {graph} px; "
              f"{seen} ({card})")
    del arts1, arts2, state, states
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[back-half] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return cases, worst


def warp_lab_phase(build_params, new_tracker, cfg, card):
    """Phase 18: the warp + LAB kernels against their twin on the main
    path's shapes, their times, and their launches on the main path's
    entry points.  Returns the kernels line's row parts: (cases, launches
    by path, launches by fleet step).  Releases its memory."""
    import gc

    import torch

    from benchmark.roofline import warp_lab_s
    from lane_tracker_tpu_torch.io.motion import motion_chunk
    from lane_tracker_tpu_torch.kernels import warp_lab as wl
    from lane_tracker_tpu_torch.parallel.streams import StreamFleet
    from lane_tracker_tpu_torch.timing import cuda_ms, queued_ms
    from lane_tracker_tpu_torch.tracker import upload
    from lane_tracker_tpu_torch.tracker.step import (
        warp_chain,
        warp_channels,
        warp_rows_plain,
    )
    from lane_tracker_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    frames = motion_chunk(T_BENCH, "cuda")
    T_slice = upload.slice_frames(frames[0].numel())
    S, T = WARP_LAB_STREAMS
    # The fleet's batch as its step gathers it: stream s at frame s of the
    # pool, T frames on (benchmark/entries/fleet.py), flattened.
    fleet_idx = (torch.arange(S)[:, None] * 7 + torch.arange(T)) % T_BENCH
    fleet_frames = frames[fleet_idx.to(frames.device)]
    cases, path_launches, fleet_launches = [], {}, {}

    def counted(fn):
        """(calls, kernels launched, kernel frames) of ``fn``, the
        wrapper's count set to 0 just before it."""
        torch.cuda.synchronize()
        wl.LAUNCHES["warp_lab"] = 0
        k0 = wl.kernel_launches()
        with profiling.recording():
            fn()
        torch.cuda.synchronize()
        frames_n = profiling.summary()["counters"].get(
            "lt.warp_lab.kernel_frames", 0)
        return wl.LAUNCHES["warp_lab"], wl.kernel_launches() - k0, frames_n

    for pipeline in WARP_LAB_PIPELINES:
        params = build_params(pipeline)
        chain = warp_chain(params)
        r0, r1 = params.raw_roi
        H, W = chain.g_warp.dst_shape
        for tag, batch in ((f"offline slice T={T_slice}", frames[:T_slice]),
                           (f"chunk T={T_BENCH}", frames),
                           (f"fleet {S} streams x {T}",
                            fleet_frames.reshape((S * T,)
                                                 + frames.shape[1:]))):
            n = batch.shape[0]
            raw = batch[:, r0:r1]
            check(wl.takes_kernel(raw, chain),
                  f"warp + LAB {pipeline} {tag}: the chain does not take "
                  "the kernels")
            n_calls, n_kernels, n_frames = counted(
                lambda: warp_channels(batch, params))
            check((n_calls, n_kernels, n_frames) == (1, 2, n),
                  f"warp + LAB {pipeline} {tag}: (calls, kernels, frames) "
                  f"{(n_calls, n_kernels, n_frames)}, not (1, 2, {n})")
            got = warp_channels(batch, params)

            def twin():
                return [warp_rows_plain(raw[k:k + WARP_LAB_TWIN_T], chain)
                        for k in range(0, n, WARP_LAB_TWIN_T)]

            want = [torch.cat(x) for x in zip(*twin())]
            diff = [int((g != w).sum()) for g, w in zip(got, want)]
            err = max(int((g.int() - w.int()).abs().max())
                      for g, w in zip(got, want))
            check(diff == [0, 0], f"warp + LAB {pipeline} {tag}: R, LAB-B "
                  f"differ from the twin's in {diff} pixels")
            del got, want

            def call():
                return warp_channels(batch, params)

            # The twin, the kernels, the kernels, the twin.
            p1 = cuda_ms(twin, 1)
            ms = queued_ms(call, WARP_LAB_REPS)
            events_ms = cuda_ms(call, WARP_LAB_REPS)
            p2 = cuda_ms(twin, 1)
            plain_ms = (p1 + p2) / 2
            bound_ms = warp_lab_s(n, r1 - r0, raw.shape[2], H, W) * 1e3
            row = {"case": f"{pipeline} {tag}", "ms": ms,
                   "events_ms": events_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes",
                   "ms_per_frame": ms / n, "plain_ms_per_frame": plain_ms / n,
                   "max_abs_err": err, "H": H, "W": W}
            cases.append(row)
            print(f"[warp-lab] {pipeline} {tag}: kernels {ms:.4f} ms queued "
                  f"({events_ms:.4f} by events; {1e3 * ms / n:.3f} us a "
                  f"frame), plain twin {plain_ms:.2f} ms ({WARP_LAB_TWIN_T} "
                  f"frames a call), bound {bound_ms:.5f} ms (bytes); R and "
                  f"LAB-B equal to the twin's; (calls, kernels) (1, 2) "
                  f"({card})")
        del params, chain

        # The main path's entry points, each count set to 0 just before:
        # the offline chunk of host frames a call a slice, one fleet step
        # a call.
        host = frames.cpu().numpy()
        tracker = new_tracker(pipeline=pipeline)
        slices = -(-T_BENCH // T_slice)
        got = counted(lambda: tracker.process_chunk(
            host, with_overlay=True, second_attempt="two_phase"))
        check(got == (slices, 2 * slices, T_BENCH),
              f"warp + LAB {pipeline} process_chunk T={T_BENCH}: (calls, "
              f"kernels, frames) {got}, not {(slices, 2 * slices, T_BENCH)}")
        path_launches[f"process_chunk {pipeline} T={T_BENCH}"] = {
            "warp_lab": got[0]}
        fleet = StreamFleet(build_params(pipeline), cfg, S, mesh=["cuda"],
                            with_overlay=True, second_attempt="two_phase")
        got = counted(lambda: fleet.step(fleet_frames))
        check(got == (1, 2, S * T), f"warp + LAB {pipeline} fleet step: "
              f"(calls, kernels, frames) {got}, not (1, 2, {S * T})")
        fleet_launches[f"two_phase {pipeline} {S}x{T}"] = {
            "warp_lab": got[:2]}
        print(f"[warp-lab] {pipeline}: process_chunk of {T_BENCH} host "
              f"frames {slices} calls ({2 * slices} kernels, {T_BENCH} "
              f"kernel frames); fleet step of {S}x{T} 1 call (2 kernels, "
              f"{S * T} kernel frames)")
        del tracker, fleet, host
    del frames, fleet_frames
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[warp-lab] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return cases, path_launches, fleet_launches


def main(argv):
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)

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
    from lane_tracker_tpu_torch.kernels import back_half as bhk
    from lane_tracker_tpu_torch.kernels import channel_fused as cf
    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.kernels import resample_mxu2 as rm
    from lane_tracker_tpu_torch.kernels import shift_chain as sc
    from lane_tracker_tpu_torch.kernels import sweep_dots as sd
    from lane_tracker_tpu_torch.kernels import tile_gather as tg
    from lane_tracker_tpu_torch.kernels import warp_lab as wl
    from lane_tracker_tpu_torch.kernels.build import build
    from lane_tracker_tpu_torch.kernels.resample import bilinear_gather
    from lane_tracker_tpu_torch.ops.color import rgb2lab_b_fast
    from lane_tracker_tpu_torch.ops.filters import filter_stage
    from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
    from lane_tracker_tpu_torch.probes import mosaic
    from lane_tracker_tpu_torch.timing import cuda_ms
    from lane_tracker_tpu_torch.tracker.config import PRESETS, SECOND_ATTEMPT
    from lane_tracker_tpu_torch.tracker.step import (
        TrackerParams,
        make_initial_state,
        warp_channels,
    )
    from lane_tracker_tpu_torch.tracker.tracker import LaneTracker

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
        if "ptxas info" in line or line.startswith("nvcc -c "):
            print(f"[build] {line.strip()}")

    # ---- 3. Frames ----
    with np.load(REPO / "assets" / "stills_720p.npz") as z:
        stills = z["frames"]
    oracles = {}
    for name in ("bench_oracle", f"bench_oracle_fail{FAIL_EVERY}"):
        with np.load(REPO / "assets" / f"{name}.npz") as z:
            oracles[name] = {k: z[k] for k in ("valid", "left", "right")}
    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")

    def build_params(pipeline, **device):
        return TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph, pipeline=pipeline, **device)

    params = build_params("corridor", device="cpu")
    gparams = build_params("corridor")
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
    errs, (r_feat, riders, b_feat, r_th, keep, am_args, r_am, b_am) = (
        filter_parity(r, b, f, f2))
    bt_args = [(b_feat, 65, f.C_b, -1),
               (b, 65, f.C_noise, f.noise_thresh)]
    errs["bilateral_threshold"] = [
        mismatches(fs.bilateral_threshold(*a),
                   fs.bilateral_threshold_plain(*a))
        for a in bt_args]
    max_err = report_parity("parity", errs, r.shape)
    n_thr = counted_launches(lambda: fs.thr_merge_open(
        r_th, b_feat, f.ksize_b, f.C_b, keep, open_k=f.open_k))
    n_mo = counted_launches(lambda: fs.merge_open(r_am, b_am, keep,
                                                  open_k=f2.open_k))
    print(f"[parity] kernel launches counted by the launchers: "
          f"thr_merge_open {n_thr}, merge_open {n_mo}")
    check((n_thr, n_mo) == (2, 1), "thr_merge_open did not take 2 kernel "
          "launches, or merge_open not 1")
    launches = {}

    # ---- 5. Slice ----
    fs.reset_launches()
    bh0 = bhk.kernel_launches()
    t0 = time.perf_counter()
    _, out = chunk_process(fresh("cuda"), gchunk, gparams, cfg,
                           with_overlay=True, second_attempt="two_phase")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    slice_launches = dict(fs.LAUNCHES)
    n_bh = bhk.kernel_launches() - bh0
    print(f"[slice] chunk_process T={T_SLICE} on the card: {first_s:.2f} s "
          f"(first call, {card}); launches {slice_launches}, back-half "
          f"kernel {n_bh}")
    check(n_bh == BACK_HALF_LAUNCHES["stills"],
          f"slice: {n_bh} launches of the back-half kernel")
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
    bh0 = bhk.kernel_launches()
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
        fcpu_params = build_params("fast", device="cpu")
        fparams = build_params("fast")
        bh0 = bhk.kernel_launches()
        _, fout = chunk_process(fresh("cuda"), gfail,
                                fparams, cfg, second_attempt="two_phase")
    torch.cuda.synchronize()
    n_bh = bhk.kernel_launches() - bh0
    print(f"[{tag}] back-half kernel launches {n_bh} (the attempt-1 scan "
          "and the rescan)")
    check(n_bh == BACK_HALF_LAUNCHES["two_phase"],
          f"{tag}: {n_bh} launches of the back-half kernel")
    launches["back_half"] = n_bh
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
        bh0 = bhk.kernel_launches()
        _, mout = chunk_process(fresh("cuda"), gfail,
                                fparams, cfg, second_attempt=mode)
        torch.cuda.synchronize()
        got = dict(fs.LAUNCHES)
        n_bh = bhk.kernel_launches() - bh0
        rmse, far = gate_close(f"{tag}: '{mode}' against two_phase", mout,
                               fout, H)
        print(f"[{tag}] '{mode}': launches {got} (second attempt expected "
              f"{want}), back-half kernel {n_bh} (expected "
              f"{BACK_HALF_LAUNCHES[mode]}); against two_phase: ints and "
              f"bools equal, curves within {rmse} px RMSE, overlay values "
              f"off by more than 1: {far}")
        check(all(got[name] > 0 for name in ATTEMPT1),
              f"{tag}: '{mode}': an attempt-1 kernel did not launch")
        check(all(got[name] == n for name, n in want.items()),
              f"{tag}: '{mode}' did not launch the second attempt's kernels "
              f"{want}")
        check(n_bh == BACK_HALF_LAUNCHES[mode],
              f"{tag}: '{mode}' launched the back-half kernel {n_bh} times")
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

    # ---- 8. Fused channel stage ----
    noise = (f.ksize_noise, f.C_noise, f.noise_thresh)
    r_args = (f.tophat_r, f.ksize_r, f.C_r)
    b_args = (f.tophat_b, f.ksize_b, f.C_b)
    cf.reset_launches()
    fused = {"channel_stage": [cf.channel_stage(r, *r_args),
                               *cf.channel_stage(b, *b_args, noise=noise)],
             "channel_stage_pyr": [cf.channel_stage_pyr(r, *r_args)]}
    torch.cuda.synchronize()
    fused_launches = dict(cf.LAUNCHES)
    Wc = r.shape[-1]
    print(f"[fused] channel_stage R {r_args}, B {b_args} noise {noise}, "
          f"channel_stage_pyr R at {tuple(r.shape)}: tiles (columns, rows) "
          f"{cf.tile(H, Wc, *r_args[:2])} (R and pyr), "
          f"{cf.tile(H, Wc, *b_args[:2], noise[0])} (B); "
          f"launches {fused_launches}")
    check(fused_launches == FUSED_LAUNCHES,
          f"the fused path did not launch {FUSED_LAUNCHES}")
    launches.update(fused_launches)
    twins = {"channel_stage": [cf.channel_stage_plain(r, *r_args),
                               *cf.channel_stage_plain(b, *b_args,
                                                       noise=noise)],
             "channel_stage_pyr": [cf.channel_stage_pyr_plain(r, *r_args)]}
    unfused_r = fs.bilateral_threshold(fs.tophat_ellipse(r, f.tophat_r),
                                       f.ksize_r, f.C_r)
    unfused = {"channel_stage": [
        unfused_r,
        fs.bilateral_threshold(fs.tophat_ellipse(b, f.tophat_b), f.ksize_b,
                               f.C_b),
        fs.bilateral_threshold(b, *noise)],
        "channel_stage_pyr": [unfused_r]}
    for name, outs in fused.items():
        vs_twin = [mismatches(g, w) for g, w in zip(outs, twins[name])]
        vs_unfused = [mismatches(g, w) for g, w in zip(outs, unfused[name])]
        print(f"[fused] {name}: mismatches against the twin "
              f"{[n for n, _ in vs_twin]}, against the unfused kernels "
              f"{[n for n, _ in vs_unfused]} (outputs in order)")
        check(all(n == 0 for n, _ in vs_twin + vs_unfused),
              f"{name} disagrees with its twin or the unfused kernels")
        max_err[name] = max(m for _, m in vs_twin)

    # ---- 9. Banded warp ----
    t0 = time.perf_counter()
    tables = rm.build_tables(cam.cam_matrix, cam.dist_coeffs, warp.M,
                             warp.image_width_height, MXU_DST)
    build_s = time.perf_counter() - t0
    gwarp = rm.MxuWarp2(tables)
    Ws, Hs, Wo, Ho, band = gwarp.geom
    pairs = torch.stack([gchunk[..., 0], rgb2lab_b_fast(gchunk)], 1)
    rm.reset_launches()
    warped = gwarp(pairs)
    torch.cuda.synchronize()
    warp_launches = dict(rm.LAUNCHES)
    print(f"[mxu] MxuWarp2 geom (Ws, Hs, Wo, Ho, band) {gwarp.geom}, host "
          f"build {build_s:.1f} s; (R, LAB-B) pairs {tuple(pairs.shape)} -> "
          f"{tuple(warped.shape)}; launches {warp_launches}")
    check(warp_launches == {"banded_pass2": 1},
          "the banded warp did not launch its pass-2 kernel once")
    launches.update(warp_launches)
    check(tuple(warped.shape) == (T_SLICE, 2, Ho, Wo)
          and warped.dtype == torch.uint8, "banded warp shape/dtype")
    t1 = gwarp.pass1(pairs)
    p2 = rm.pass2(t1, gwarp.wpack, Wo)
    p2_err = [mismatches(p2, rm.pass2_plain(t1, gwarp.wpack, Wo)),
              mismatches(p2, warped)]
    print(f"[mxu] pass 2 against its twin: {p2_err[0][0]} differ (max "
          f"{p2_err[0][1]}); against the warp's own: {p2_err[1][0]}")
    check(p2_err[0][0] == 0 and p2_err[1][0] == 0,
          "pass 2 disagrees with its twin")
    max_err["banded_pass2"] = p2_err[0][1]
    t0 = time.perf_counter()
    cpu_warped = rm.MxuWarp2(tables, device="cpu")(pairs[:T_WARP_CPU].cpu())
    n_cpu, m_cpu = mismatches(warped[:T_WARP_CPU].cpu(), cpu_warped)
    print(f"[mxu] CPU path T={T_WARP_CPU}: {time.perf_counter() - t0:.1f} "
          f"s; card vs CPU: {n_cpu} values differ (max {m_cpu})")
    check(n_cpu == 0, "the banded warp on the card differs from the CPU")
    fast = build_params("fast")
    ry0, ry1 = fast.raw_roi

    def two_stage(p):
        """The exact two-stage warp of (T, 2, Hs, Ws) pairs, as
        (T, 2, Ho, Wo)."""
        hw = p.permute(0, 2, 3, 1)[:, ry0:ry1].contiguous()
        und = bilinear_gather(hw, fast.grid_und_roi)
        return bilinear_gather(und, fast.grid_warp_roi).permute(0, 3, 1, 2)

    exact = two_stage(pairs)
    d = (warped.int() - exact.int()).abs()
    print(f"[mxu] against the exact two-stage bilinear_gather warp (not "
          f"gated): {int((d != 0).sum())} of {d.numel()} values differ, "
          f"{int((d > 2).sum())} by more than 2, max {int(d.max())}, "
          f"mean abs {float(d.float().mean()):.4f}")
    del t1, p2, exact, d

    # ---- 11. Morphology probes (before the timing phase) ----
    for mod in (sc, fs, sd, tg):
        mod.reset_launches()
    t0 = time.perf_counter()
    probe_rows = mosaic.run("cuda")
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    counts = sc.LAUNCHES | fs.LAUNCHES | sd.LAUNCHES | tg.LAUNCHES
    probe_launches = {name: counts[name] for name in PROBE_LAUNCHES}
    print(f"[probes] probes.mosaic.run at full size: {len(probe_rows)} "
          f"rows in {probe_s:.1f} s; launches {probe_launches}")
    for row in probe_rows:
        print(f"[probes] {json.dumps(row)}")
    chains = [row for row in probe_rows
              if row.get("kernel") in ("shift_chain", "shift_chain_2d")]
    check([row["variant"] for row in probe_rows if "error" in row]
          == ["i16_sublane_slice_add_s17"],
          "the probes did not reject exactly i16_sublane_slice_add_s17")
    check(len(chains) == 64 and all(row["launches"] == 1 for row in chains),
          "a shift-chain variant did not run in one launch of its kernel")
    bad = [mosaic.row_name(row) for row in probe_rows
           if "error" not in row and not mosaic.row_ok(row)]
    check(not bad, f"probe rows disagree with their plain twins: {bad}")
    check(probe_launches == PROBE_LAUNCHES,
          f"the probes did not launch {PROBE_LAUNCHES}")
    overlap = {row["kind"]: row for row in probe_rows
               if row.get("kernel") == "sweep_dots"}
    check(list(overlap) == list(sd.KINDS)
          and all(row["launches"] == 1 and row["swept_mismatches"] == 0
                  for row in overlap.values())
          and overlap["sweeps"]["max_abs_err"] == 0
          and all(overlap[k]["max_rel_err"] <= sd.RTOL
                  for k in ("dots", "both")),
          "sweep_dots: swept differs from its twin, or out is not equal "
          f"(sweeps) / within rtol {sd.RTOL} (dots, both)")
    gathers = [row for row in probe_rows if row.get("kernel") == "tile_gather"]
    check([row["probe"] for row in gathers] == list(tg.OPS)
          and all(row["ok"] and row["launches"] == len(tg.REPS)
                  for row in gathers),
          "tile_gather differs from its twin")
    # The in-tile gather's design (csrc/tile_gather.cu): B0, G1 and G2 have
    # no barrier at all, G3 one CTA barrier a rep in a loop not unrolled,
    # so one BAR.SYNC in its instance (the first design's 45-58).
    gather_sass = {}
    for op, code in tg.OPS.items():
        kernel = f"tile_gather_kernelILi{code}E"
        check(len(sass_count(lib_path, kernel, "EXIT")[1]) == 1,
              f"no single tile_gather_kernel instance for {op}")
        gather_sass[op] = {opcode: sass_count(lib_path, kernel, opcode)[0]
                           for opcode in ("BAR.SYNC", "SHFL")}
    print(f"[probes] SASS of tile_gather_kernel by op: "
          f"{json.dumps(gather_sass)}")
    check(all(c["BAR.SYNC"] == (op == "G3_2d_gather")
              for op, c in gather_sass.items()),
          "a tile_gather_kernel instance holds a CTA barrier (BAR.SYNC) "
          "its design has not: none in B0, G1 and G2, one in G3's loop")
    n_hgmma, hgmma_fns = sass_count(lib_path, "sweep_dots_kernel", "HGMMA")
    print(f"[probes] SASS of {lib_path.name}: {n_hgmma} HGMMA instructions "
          f"in {hgmma_fns}")
    check(n_hgmma > 0, "no warpgroup tensor-core (HGMMA) instruction in "
          "sweep_dots' kernel")
    launches.update({name: probe_launches[name] for name in PROBE_KERNELS})
    for name in PROBE_KERNELS:
        max_err[name] = max(row["max_abs_err"] for row in probe_rows
                            if row.get("kernel") == name)
    # The dual tophat in 1 kernel launch, two one-launch tophat_ellipse calls
    # in 2, and each staged tophat call in 1, counted by the library's
    # launchers on 8 warped frames.
    r10, b10 = mosaic.warped_channels(8, "cuda")
    n_dual = counted_launches(lambda: fs.dual_tophat(r10, b10, 29, 55))
    n_sep = counted_launches(lambda: (fs.tophat_ellipse(r10, 29),
                                      fs.tophat_ellipse(b10, 55)))
    n_staged = [counted_launches(lambda k=k, dt=dt: fs.tophat_staged(
        r10, k, dt)) for _, k, dt in mosaic.PROBE5]
    print(f"[probes] kernel launches counted by the launchers: dual_tophat "
          f"{n_dual}; two tophat_ellipse calls {n_sep}; tophat_staged "
          f"calls {n_staged}")
    check(n_dual == DUAL_LAUNCHES and n_sep == 2
          and n_staged == [1] * len(mosaic.PROBE5),
          f"the dual tophat did not take {DUAL_LAUNCHES} launch, two "
          "tophat_ellipse calls not 2, or a tophat_staged call not 1")
    del r10, b10
    # The 2-D chain in the kernel launches the library's plan says, a
    # single-axis chain in one, counted by the library's launchers.
    morph = sc.BY_NAME["bf16_morph_chain8"]
    roll = sc.BY_NAME["i32_lane_roll_add_s17"]
    xm, xr = (sc.make_input(v, device="cuda") for v in (morph, roll))
    n_2d = counted_launches(lambda: sc.shift_chain(xm, morph))
    n_1d = counted_launches(lambda: sc.shift_chain(xr, roll))
    want_2d = sc.chain_plan(morph)["launches"]
    print(f"[probes] kernel launches a call, counted by the launchers: "
          f"lt_shift_chain_2d {n_2d} ({morph.n_passes()} outer steps, "
          f"{want_2d} launches planned); lt_shift_chain {n_1d}")
    check(n_2d == want_2d and n_1d == 1,
          f"lt_shift_chain_2d did not take {want_2d} kernel launches, or "
          "lt_shift_chain not 1")
    del xm, xr

    # ---- 12. User surface (before the timing phase) ----
    kw = process_kwargs(cfg)
    path_launches = {}

    def new_tracker(**kw):
        """demo1's LaneTracker; ``kw``: ``device``, ``pipeline``,
        ``latency_mode``."""
        return LaneTracker(
            warp.image_width_height, warp.warped_width_height,
            cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
            (warp.mppv, warp.mpph), validity=cfg.validity, **kw)

    frames8 = stills[np.arange(N_PROCESS) % len(stills)]
    tracker = new_tracker()
    check(tracker.params.fwd_u.is_cuda and tracker.device.type == "cuda",
          "LaneTracker without a device argument is not on the card")
    fs.reset_launches()
    t0 = time.perf_counter()
    pout, plines = drive_process(tracker, frames8, kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = dict(fs.LAUNCHES)
    path_launches["process"] = got
    print(f"[process] LaneTracker.process, 'fast', demo1, {N_PROCESS} "
          f"frames with diagnostics on the card: {first_s:.2f} s (first "
          f"calls); launches {got}")
    check(all(got[name] == N_PROCESS for name in ATTEMPT1),
          f"process: an attempt-1 kernel did not launch once a frame")
    check(all(got[name] == 0 for name in SECOND_ATTEMPT_LAUNCHES),
          "process: the second attempt ran on the stills")
    gate_oracle("process", pout, oracles["bench_oracle"], H)
    t0 = time.perf_counter()
    cpu_out, cpu_lines = drive_process(new_tracker(device="cpu"), frames8,
                                       kw)
    print(f"[process] CPU path, {N_PROCESS} frames: "
          f"{time.perf_counter() - t0:.1f} s")
    compare_cpu("process", pout, cpu_out)
    n_lines = sum(map(len, plines))
    diff_lines = [(t, a, b) for t, (la, lb) in enumerate(zip(plines,
                                                             cpu_lines))
                  for a, b in zip(la, lb) if a != b]
    print(f"[process] diagnostics transcript: {n_lines} lines; lines "
          f"differing from the CPU run's: {diff_lines}")
    check(plines == cpu_lines,
          "process: the transcript differs from the CPU run's")
    chunk_tracker = new_tracker()
    chunk_out = chunk_tracker.process_chunk(frames8, **kw)
    rmse, far = gate_close("process_chunk against process", chunk_out,
                           pout, H)
    print(f"[process] process_chunk (two_phase, the back-half kernel) on "
          f"the same frames from a fresh state against process (the "
          f"per-frame loop): ints and bools equal, curves within {rmse} px "
          f"RMSE, overlay values off by more than 1: {far}; success ratio "
          f"{chunk_tracker.get_success_ratio()} (process "
          f"{tracker.get_success_ratio()})")
    check(chunk_tracker.get_success_ratio() == tracker.get_success_ratio(),
          "process_chunk's success ratio differs from process's")
    snap = REPO / "build" / "chip_smoke_state.npz"
    snap.parent.mkdir(exist_ok=True)
    ta, tb = new_tracker(), new_tracker()
    for frame in frames8[:4]:
        ta.process(frame, **kw)
    ta.save_state(snap)
    tb.load_state(snap)
    snap.unlink()
    resumed = []
    for frame in frames8[4:]:
        fa, fb = ta.process(frame, **kw), tb.process(frame, **kw)
        resumed.append(bool(np.array_equal(fa, fb)) and not same_outputs(
            ta.last_output, tb.last_output))
    print(f"[process] save_state after frame 3, load_state, frames 4-7: "
          f"identical {resumed}")
    check(all(resumed), "a snapshot round trip did not continue identically")
    annotated, viz = tracker.process(frames8[0], visualize_search=True, **kw)
    split = tracker.process(frames8[1], split_view=True, **kw)
    shapes = (annotated.shape, viz.shape, split.shape)
    print(f"[process] visualize_search {shapes[:2]}, split_view {shapes[2]}")
    check(shapes == ((720, 1280, 3), (1100, 1080, 3), (1372, 1280, 3)),
          "visualize_search or split_view shapes differ from the reference's")
    del ta, tb, chunk_tracker, chunk_out

    # 'compat' on the 64 stills, every kernel launch's image recorded.
    cparams, ccpu_params = build_params("compat"), build_params(
        "compat", device="cpu")
    widths = []

    def recording(name):
        launch = getattr(fs, name)

        def call(img, *args, **kwargs):
            widths.append((name, tuple(img.shape)))
            return launch(img, *args, **kwargs)

        return call

    fs.reset_launches()
    with mock.patch.multiple(fs, **{n: recording(n) for n in LAUNCHERS}):
        _, cout = chunk_process(fresh("cuda"), gchunk, cparams, cfg,
                                second_attempt="two_phase")
        torch.cuda.synchronize()
    got = dict(fs.LAUNCHES)
    path_launches["compat"] = got
    print(f"[compat] chunk_process T={T_SLICE}, two_phase: launches {got}; "
          f"launch images {sorted(set(widths))}")
    check(all(got[name] > 0 for name in ATTEMPT1),
          "compat: an attempt-1 kernel did not launch")
    check(widths and all(shape[-1] == 1080 for _, shape in widths),
          "compat: a kernel launched at another width than 1080")
    check(tuple(cout.overlay.shape) == (T_SLICE, 720, 1280, 3),
          "compat: overlay shape")
    gate_oracle("compat", cout, oracles["bench_oracle"], H)
    t0 = time.perf_counter()
    _, ccpu = chunk_process(fresh("cpu"), chunk[:T_CPU], ccpu_params, cfg,
                            second_attempt="two_phase")
    print(f"[compat] CPU path T={T_CPU}: {time.perf_counter() - t0:.1f} s")
    compare_cpu("compat", cout, ccpu)
    del cparams, cout

    # 'neighborhood' with the noise mask on the slice's corridor channels.
    fn = dataclasses.replace(f2, mask_noise=True)
    fs.reset_launches()
    nb = filter_stage(r, b, fn)
    torch.cuda.synchronize()
    got = {name: n for name, n in fs.LAUNCHES.items() if n}
    path_launches["neighborhood_mask_noise"] = got
    keep_nb = fs.bilateral_threshold_plain(b, fn.ksize_noise, fn.C_noise,
                                           fn.noise_thresh)
    want = fs.merge_open_plain(
        fs.adaptive_mean_plain(r, fn.ksize_r, -fn.C_r),
        fs.adaptive_mean_plain(b, fn.ksize_b, -fn.C_b), keep_nb, fn.open_k)
    nb_err = [mismatches(nb[0], want[0]),
              mismatches(nb[1].packed, want[1].packed)]
    print(f"[neighborhood] filter_stage 'neighborhood' + mask_noise "
          f"(noise_thresh {fn.noise_thresh}, ksize_noise {fn.ksize_noise}) "
          f"at {tuple(r.shape)}: launches {got}; against the plain chain "
          f"mismatches {[n for n, _ in nb_err]}")
    check(got == NEIGHBORHOOD_NOISE_LAUNCHES,
          f"neighborhood + mask_noise did not launch "
          f"{NEIGHBORHOOD_NOISE_LAUNCHES}")
    check(all(n == 0 for n, _ in nb_err),
          "neighborhood + mask_noise disagrees with its plain chain")
    del nb, want, keep_nb

    # The CLI in a subprocess.
    cli_dir = REPO / "build" / "chip_smoke_cli"
    cli_dir.mkdir(parents=True, exist_ok=True)
    np.savez(cli_dir / "in.npz", frames=chunk.numpy())
    cli_cmd = [sys.executable, "-m", "lane_tracker_tpu_torch",
               str(cli_dir / "in.npz"), str(cli_dir / "out.rgb24"),
               "--calibration", str(REPO / "assets" / "calibration.npz"),
               "--chunk", str(CLI_CHUNK),
               "--per-frame-log", str(cli_dir / "log.jsonl"),
               "--metrics-json", str(cli_dir / "metrics.json")]
    t0 = time.perf_counter()
    res = subprocess.run(cli_cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    print(f"[cli] python -m lane_tracker_tpu_torch on {T_SLICE} frames, "
          f"--chunk {CLI_CHUNK}: exit {res.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in res.stdout.splitlines():
        print(f"[cli]   {line}")
    check(res.returncode == 0, f"the CLI failed: {res.stderr[-2000:]}")
    log = [json.loads(x) for x in
           (cli_dir / "log.jsonl").read_text().splitlines()]
    cli_valid = np.array([x["valid"] for x in log])
    n_diff = int((cli_valid != oracles["bench_oracle"]["valid"][:T_SLICE])
                 .sum()) if len(log) == T_SLICE else T_SLICE
    print(f"[cli] per-frame log: {len(log)} frames, valid "
          f"{int(cli_valid.sum())}; frames differing from the oracle "
          f"{n_diff}; metrics {(cli_dir / 'metrics.json').read_text()}")
    check(n_diff == 0, "the CLI's validity differs from the oracle")
    cli_fps_line = res.stdout.strip().splitlines()[-1]
    for name in ("in.npz", "out.rgb24", "out.rgb24.json", "log.jsonl",
                 "metrics.json"):
        (cli_dir / name).unlink()

    def time_process(when):
        """The per-frame API: one frame a call, state carried, host work
        (text, the overlay's copy to the host) included; the tracker."""
        ttr = new_tracker()
        med, lo, hi = frame_ms(lambda i: ttr.process(frames8[i % N_PROCESS],
                                                     **kw))
        print(f"[timing] LaneTracker.process ('fast', demo1), {when}: "
              f"median {med:.3f} ms a frame over {N_PROCESS_TIMED} frames "
              f"after 4 warm-up frames (min {lo:.3f}, max {hi:.3f}; CUDA "
              f"events) ({card})")
        return ttr

    # The same timing before phase 13 as in phase 10 after it, in one run.
    time_process("before phase 13")

    # ---- 13. Fleet (before the timing phase) ----
    fleet_launches, fleet_err = fleet_phase(stills, oracles, build_params,
                                            cfg, card)

    # ---- 14. Gaps (before the timing phase) ----
    time_process("before phase 14")
    gaps_phase(stills, oracles, build_params, cfg, card)
    time_process("after phase 14")

    # ---- 15. Opt-in modes (before the timing phase) ----
    modes_phase(stills, oracles, build_params, new_tracker, cfg, card,
                path_launches)
    time_process("after phase 15")

    # ---- 16. The measuring entry points (before the timing phase) ----
    torch.cuda.empty_cache()
    bench_phase(kind, card, oracles, path_launches)

    # ---- 17. The back-half kernel (before the timing phase) ----
    back_half_cases, max_err["back_half"] = back_half_phase(
        build_params, cfg, card)

    # ---- 18. The warp + LAB kernels (before the timing phase) ----
    warp_lab_cases, warp_paths, warp_fleet = warp_lab_phase(
        build_params, new_tracker, cfg, card)
    max_err["warp_lab"] = max(c["max_abs_err"] for c in warp_lab_cases)
    launches["warp_lab"] = next(iter(warp_paths.values()))["warp_lab"]
    path_launches.update(warp_paths)
    fleet_launches.update(warp_fleet)

    # ---- 10. Timing (not gated) ----
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

    ttr = time_process("after phases 13, 14 and the chunk timings")
    print(f"[timing] CLI on {T_SLICE} frames, --chunk {CLI_CHUNK}: "
          f"{cli_fps_line} ({card})")
    # Where a process() call's time goes: N_PROCESS frames under the
    # profiler, read through the lt.* ranges tracker_step opens
    # (scripts/torch_chunk_breakdown.py's reader), per frame.
    events, wall_ms = traced(lambda: [ttr.process(frame, **kw)
                                      for frame in frames8])
    print_stages("profile", "LaneTracker.process, per frame", events,
                 wall_ms, N_PROCESS, card)
    del ttr, tracker

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
        # Phase 8's two calls (R; LAB-B with the noise mask), and its pyr
        # call, at their default tiles.
        "channel_stage": (
            lambda: [cf.channel_stage(r, *r_args),
                     cf.channel_stage(b, *b_args, noise=noise)],
            lambda: [cf.channel_stage_plain(r, *r_args),
                     cf.channel_stage_plain(b, *b_args, noise=noise)]),
        "channel_stage_pyr": (
            lambda: cf.channel_stage_pyr(r, *r_args),
            lambda: cf.channel_stage_pyr_plain(r, *r_args)),
        "banded_pass2": (
            lambda: rm.pass2(t1, gwarp.wpack, Wo),
            lambda: rm.pass2_plain(t1, gwarp.wpack, Wo)),
    }
    # The least time of each timed call: (bytes, (operations, their
    # type), ...).
    N = r.numel()
    pref_bytes = 4 * N // r.shape[-1] * (r.shape[-1] + 1)
    t1 = gwarp.pass1(pairs)
    u8, i32 = "uint8", "int32"
    work = {
        "tophat_ellipse": (2 * N, (N * tophat_ops(f.tophat_r), u8)),
        "tophat_riders": (5 * N, (N * (tophat_ops(f.tophat_b) + NOISE_OPS),
                                  u8), (N * 2 * THRESHOLD_OPS, i32)),
        "thr_merge_open": (4 * N + pref_bytes,
                           (N * (MERGE_OPS + 2 * morph_ops(f.open_k)), u8),
                           (N * (THRESHOLD_OPS + PREFIX_OPS), i32)),
        "adaptive_mean": (4 * N, (2 * N * ADAPTIVE_OPS, i32)),
        "merge_open": (3 * N + pref_bytes,
                       (N * (MERGE_OPS + 2 * morph_ops(f2.open_k)), u8),
                       (N * PREFIX_OPS, i32)),
        "bilateral_threshold": (2 * N, (N * THRESHOLD_OPS, i32)),
        "channel_stage": (5 * N, (N * (tophat_ops(f.tophat_r)
                                       + tophat_ops(f.tophat_b)
                                       + NOISE_OPS), u8),
                          (N * 3 * THRESHOLD_OPS, i32)),
        "channel_stage_pyr": (2 * N, (N * tophat_ops(f.tophat_r), u8),
                              (N * THRESHOLD_OPS, i32)),
        "banded_pass2": (4 * t1.numel() + 4 * gwarp.wpack.numel()
                         + warped.numel(),
                         (warped.numel() * PASS2_FLOPS, "float32")),
    }
    mods = (fs, cf, rm, sc, sd, tg, bhk, wl)
    sources = {k: v for m in mods for k, v in m.SOURCE.items()}
    replaces = {k: v for m in mods for k, v in m.REPLACES.items()}
    kernels = []

    def add_kernel(name, ms, plain_ms, bound_ms, bound_by, library_ms=None,
                   **extra):
        # No single PyTorch call computes any of these functions (an
        # elliptical tophat, a cross threshold, cv2's MEAN_C threshold, a
        # merge + open + packed prefixes, pass 2's rounded two-tap lerp, a
        # K-pass shift chain, a chain of in-tile gathers); probe 6's
        # products alone are one batched torch.matmul, its library_ms,
        # which ``library_of`` names the row of and that row's ms.
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "path_launches": {path: got[name]
                              for path, got in path_launches.items()
                              if got.get(name)},
            "fleet_launches": {step: got[name][0]
                               for step, got in fleet_launches.items()
                               if name in got},
            "fleet_kernel_launches": {step: got[name][1]
                                      for step, got in fleet_launches.items()
                                      if name in got},
            "fleet_max_abs_err": fleet_err.get(name),
            **extra,
        })

    for name, (kernel, twin) in calls.items():
        # plain, kernel, kernel, plain: the means of each pair.
        p1 = cuda_ms(twin, 3)
        k1 = cuda_ms(kernel, 10)
        k2 = cuda_ms(kernel, 10)
        p2 = cuda_ms(twin, 3)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        nbytes, *ops = work[name]
        bound_ms, bound_by = bound(*work[name])
        print(f"[timing] {name}: kernel {ms:.3f} ms, plain twin "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {sum(n for n, _ in ops) / 1e9:.2f} "
              f"G ops) ({card})")
        add_kernel(name, ms, plain_ms, bound_ms, bound_by)
    # Phase 17's back-half kernel: the row is one stream's two-attempt scan
    # of T_BENCH frames (two_phase's rescan), its twin that scan's
    # per-frame loop; ``cases`` holds each shape.
    row = back_half_cases[1]
    add_kernel("back_half", row["ms"], row["plain_ms"], row["bound_ms"],
               row["bound_by"], cases=back_half_cases)
    # Phase 18's warp + LAB kernels: the row is 'fast''s call on the offline
    # chunk's slice, the main path's call; ``cases`` holds each pipeline
    # and shape.
    row = warp_lab_cases[0]
    add_kernel("warp_lab", row["ms"], row["plain_ms"], row["bound_ms"],
               row["bound_by"], cases=warp_lab_cases)

    # Rows 1-3 and 5 launch by launch, each entry called alone on the main
    # path's input, with its own bound; the rows' kernels entries list them
    # as "launches_ms".
    by_row = {}
    for row, launch, work_l, call in single_launches(
            f, f2, r, b, r_feat, b_feat, r_th, keep, r_am, b_am):
        bound_l, by_l = bound(*work_l)
        part = {"launch": launch, "bound_ms": bound_l, "bound_by": by_l}
        k1 = cuda_ms(call, LAUNCH_REPS)
        k2 = cuda_ms(call, LAUNCH_REPS)
        part["ms"] = (k1 + k2) / 2
        print(f"[launch] {row}: {launch}: kernel {part['ms']:.4f} ms, bound "
              f"{bound_l:.4f} ms ({by_l}) ({card})")
        by_row.setdefault(row, []).append(part)
    for entry in kernels:
        if entry["name"] in by_row:
            entry["launches_ms"] = by_row[entry["name"]]

    # Phase 11's kernels, timed once, in the probes' own rows: us per pass
    # of each chain (its time over K, as the probes divide) with its bound
    # and the shuffle and shared traffic its design moves per pass, ms per frame
    # of each tophat row with the bound of one call.  A kernel's entry in
    # the kernels line sums its rows: the 63 single-axis chains, the 2-D
    # chain, probe 5's three staged tophats, the dual tophat on the T=128
    # warped channels, probe 6's three kinds, probe 11's four ops at both
    # chain lengths.
    chain_in = {v.name: sc.make_input(v, device="cuda") for v in sc.VARIANTS
                if not v.rejected}
    n5 = mosaic.TOPHAT_T * mosaic.TOPHAT_HW[0] * mosaic.TOPHAT_HW[1]
    n10 = mosaic.DUAL_T * mosaic.TOPHAT_HW[0] * mosaic.TOPHAT_HW[1]
    timed = {name: [] for name in PROBE_KERNELS}

    def emit(row):
        name = row.get("variant")
        if row.get("kernel") == "sweep_dots":
            row["bound_ms"], row["bound_by"] = bound(
                *sweep_dots_work(row["kind"]))
        elif row.get("kernel") == "tile_gather":
            parts = [bound(*gather_work(row["probe"], n)) for n in tg.REPS]
            row["bound_ms"] = sum(t for t, _ in parts)
            row["bound_by"] = parts[-1][1]
        elif name in chain_in:
            v = sc.BY_NAME[name]
            row["bound_ms"], row["bound_by"] = bound(
                *chain_work(v, chain_in[name], sc.K))
            row["traffic_per_pass"] = chain_traffic_per_pass(
                v, chain_in[name])
        elif "k" in row:
            row["bound_ms"], row["bound_by"] = bound(
                2 * n5, (n5 * tophat_ops(row["k"]), row["staging"]))
        elif "stage" in row:
            parts = [bound(2 * n10, (n10 * tophat_ops(k), "uint8"))
                     for k in mosaic.DUAL_K]
            row["bound_ms"] = sum(t for t, _ in parts)
            row["bound_by"] = parts[-1][1]
        if row.get("kernel") in timed:
            timed[row["kernel"]].append(row)
        print(f"[probes] {json.dumps(row)} ({card})")

    mosaic.run("cuda", reps=PROBE_REPS, emit=emit)
    for name, rows in timed.items():
        bound_ms = sum(row["bound_ms"] for row in rows)
        bound_by = max(("bytes", "operations"), key=lambda by: sum(
            row["bound_ms"] for row in rows if row["bound_by"] == by))
        ms = sum(row.get("ms_k_passes", row.get("ms")) for row in rows)
        plain_ms = sum(row["plain_ms"] for row in rows)
        extra = {}
        if "events_ms_k_passes" in rows[0]:
            # the chains' rows by CUDA events alone, as they were timed
            # before the spin kernel, comparable with earlier runs
            extra["events_ms"] = sum(row["events_ms_k_passes"]
                                     for row in rows)
        lib = next((row for row in rows if "library_ms" in row), None)
        library_of = {} if lib is None else {
            "library_of": lib["kind"], "library_of_ms": lib["ms"]}
        print(f"[timing] {name}: kernel {ms:.3f} ms, plain twin "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}) over "
              f"its {len(rows)} probe rows"
              + ("" if not extra else
                 f" (by CUDA events alone {extra['events_ms']:.3f} ms)")
              + ("" if lib is None else
                 f"; library {lib['library_ms']:.3f} ms against the "
                 f"{lib['kind']!r} row's {lib['ms']:.3f} ms") + f" ({card})")
        extra.update(library_of)
        if name == "shift_chain_2d":
            extra["kernel_launches_a_call"] = n_2d
        if name == "tile_gather":
            extra["ns_per_rep"] = {row["probe"]: row["ns_per_rep"]
                                   for row in rows}
            extra["bound_ns_per_rep"], extra["int32_bound_ns_per_rep"] = (
                {row["probe"]: gather_bound_ns_per_rep(row["probe"], lanes)
                 for row in rows} for lanes in ("uint8", "int32"))
            extra["sass"] = gather_sass
        add_kernel(name, ms, plain_ms, bound_ms, bound_by,
                   lib and lib["library_ms"], **extra)
    del chain_in

    # scripts/mosaic_probe7.py's study on this card: the fused stage at
    # several tiles against the unfused kernels on the same inputs, in
    # turns (unfused, each tile, each tile back, unfused): the planned
    # tile, then rows asked of 32, 64, H/4 and H/2, each clamped to what
    # fits at the width that suits it.
    study = (
        ("R", r, r_args, None,
         lambda: fs.bilateral_threshold(fs.tophat_ellipse(r, f.tophat_r),
                                        f.ksize_r, f.C_r)),
        ("B + noise", b, b_args, noise,
         lambda: (fs.bilateral_threshold(fs.tophat_ellipse(b, f.tophat_b),
                                         f.ksize_b, f.C_b),
                  fs.bilateral_threshold(b, *noise))),
    )
    for tag_s, x, args, nz, unfused_fn in study:
        kn = nz[0] if nz else 0
        asked = {}
        for want_h in (None, 32, 64, H // 4, H // 2):
            got = cf.tile(H, x.shape[-1], *args[:2], kn, want_h)
            asked.setdefault(got, want_h)
        order = ["unfused", *asked, *list(asked)[::-1], "unfused"]
        times = {}
        for key in order:
            fn = unfused_fn if key == "unfused" else (
                lambda h_=asked[key]: cf.channel_stage(x, *args, noise=nz,
                                                       block=h_))
            times.setdefault(key, []).append(cuda_ms(fn, 5))
        for key, ts in times.items():
            what = "unfused kernels" if key == "unfused" else (
                f"fused, tiles of {key[1]} x {key[0]}"
                + (" (planned)" if asked[key] is None else ""))
            runs = ", ".join(f"{t:.3f}" for t in ts)
            print(f"[study] {tag_s} at {tuple(x.shape)}: {what}: "
                  f"{sum(ts) / len(ts):.3f} ms (runs {runs}) ({card})")

    # The banded warp at T=64 against the two-stage warp of the same pairs.
    warp_times = {}
    for name_w in ("two-stage", "MxuWarp2", "MxuWarp2", "two-stage"):
        fn = (lambda: gwarp(pairs)) if name_w == "MxuWarp2" else (
            lambda: two_stage(pairs))
        warp_times.setdefault(name_w, []).append(cuda_ms(fn, 3))
    for name_w, ts in warp_times.items():
        print(f"[timing] {name_w} warp of the {tuple(pairs.shape)} pairs: "
              f"{sum(ts) / len(ts):.3f} ms ({card})")
    del t1

    # One fail16 chunk per mode under the profiler, read through its lt.*
    # ranges with scripts/torch_chunk_breakdown.py's reader; that script's
    # stills chunks never open the fallback's range, so it is added here.
    # In 'cond' each failing frame's lt.second_attempt nests inside
    # lt.back_half: the reader counts that range's host time in both, and
    # gives the back half's kernels launched after it to (outside).
    for mode in TIMED_MODES:
        st = fresh("cuda")
        events, wall_ms = traced(lambda: chunk_process(
            st, gfail, gparams, cfg, second_attempt=mode))
        print_stages("profile", f"{tag} chunk, {mode}", events, wall_ms, 1,
                     card)
    fleet_profile(stills, build_params, cfg, card)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
