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
   state must give ``process``'s outputs exactly; a ``save_state`` /
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
(``process`` over 8 frames, 'compat' on 64, 'neighborhood' + mask_noise).  Without CUDA, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import functools
import importlib
import io
import json
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
    from torch.profiler import ProfilerActivity, profile

    from lane_tracker_tpu_torch.calib.io import load_calibration_npz
    from lane_tracker_tpu_torch.kernels import channel_fused as cf
    from lane_tracker_tpu_torch.kernels import filter_stage as fs
    from lane_tracker_tpu_torch.kernels import resample_mxu2 as rm
    from lane_tracker_tpu_torch.kernels import shift_chain as sc
    from lane_tracker_tpu_torch.kernels import sweep_dots as sd
    from lane_tracker_tpu_torch.kernels import tile_gather as tg
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
        fcpu_params = build_params("fast", device="cpu")
        fparams = build_params("fast")
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

    def new_tracker(**device):
        return LaneTracker(
            warp.image_width_height, warp.warped_width_height,
            cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
            (warp.mppv, warp.mpph), validity=cfg.validity, **device)

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
    diff = same_outputs(chunk_out, pout)
    print(f"[process] process_chunk (two_phase) on the same frames from a "
          f"fresh state: fields differing from process {diff}; success "
          f"ratio {chunk_tracker.get_success_ratio()} (process "
          f"{tracker.get_success_ratio()})")
    check(not diff and chunk_tracker.get_success_ratio()
          == tracker.get_success_ratio(),
          "process_chunk differs from process")
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

    # The per-frame API: one frame a call, state carried, host work
    # (text, the overlay's copy to the host) included.
    ttr = new_tracker()
    for frame in frames8[:4]:
        ttr.process(frame, **kw)
    frame_ms = []
    for i in range(N_PROCESS_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ttr.process(frames8[i % N_PROCESS], **kw)
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
    print(f"[timing] LaneTracker.process ('fast', demo1): median "
          f"{float(np.median(frame_ms)):.3f} ms a frame over "
          f"{N_PROCESS_TIMED} frames after 4 warm-up frames (min "
          f"{min(frame_ms):.3f}, max {max(frame_ms):.3f}; CUDA events) "
          f"({card})")
    print(f"[timing] CLI on {T_SLICE} frames, --chunk {CLI_CHUNK}: "
          f"{cli_fps_line} ({card})")
    # Where a process() call's time goes: N_PROCESS frames under the
    # profiler, read through the lt.* ranges tracker_step opens
    # (scripts/torch_chunk_breakdown.py's reader), per frame.
    breakdown = importlib.import_module("scripts.torch_chunk_breakdown")
    ptrace = REPO / "build" / "chip_smoke_process_trace.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames8:
            ttr.process(frame, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / N_PROCESS
    prof.export_chrome_trace(str(ptrace))
    stages = breakdown.stage_table(
        json.loads(ptrace.read_text())["traceEvents"], N_PROCESS)
    ptrace.unlink()
    busy = sum(v["device_ms"] for v in stages.values())
    in_ranges = sum(v["host_ms"] for v in stages.values())
    print(f"[profile] LaneTracker.process under torch.profiler, per frame "
          f"over {N_PROCESS}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1.0 - busy / wall_ms:.3f}, host "
          f"outside the lt.* ranges {wall_ms - in_ranges:.3f} ms ({card})")
    for name, v in stages.items():
        print(f"[profile]   {name:18s} host {v['host_ms']:10.3f} ms  "
              f"device {v['device_ms']:9.3f} ms  launches "
              f"{v['launches']:7.1f}")
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
    mods = (fs, cf, rm, sc, sd, tg)
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
    breakdown = importlib.import_module("scripts.torch_chunk_breakdown")
    trace = REPO / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(exist_ok=True)
    def profile_chunk(mode, tag_p):
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
        print(f"[{tag_p}] {tag} chunk, {mode}, under torch.profiler: wall "
              f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1.0 - busy / wall_ms:.3f} ({card})")
        for name, v in stages.items():
            print(f"[{tag_p}]   {name:18s} host {v['host_ms']:10.3f} ms  "
                  f"device {v['device_ms']:9.3f} ms  launches "
                  f"{v['launches']:7.0f}")

    for mode in TIMED_MODES:
        profile_chunk(mode, "profile")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
