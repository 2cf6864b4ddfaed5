"""The redesigned kernels against an earlier checkout's, on the card.

Rows 3 and 5 of the filter (``thr_merge_open``, ``merge_open``: the
merge + open + prefix tail as one bit-packed kernel), probe 6's
``sweep_dots`` (the products on wgmma), row 4's ``adaptive_mean`` (row
and column walkers of running sums), the fused channel stage
(``lt_channel_stage``: the tophat's widening plane over wide tiles) and
probes 5 and 10's ``tophat_staged`` and ``dual_tophat`` (the widening
plane in bf16 or f32 lanes; both problems' tiles in one launch) and
the morphology probes' shift chains (``lt_shift_chain``: lines in
registers along the shift's orbits; ``lt_shift_chain_2d``: tiles run a few
outer steps in shared memory, no grid barrier) and probe 11's in-tile
gather (``lt_tile_gather``: bytes, the gathers through ``__shfl_sync`` and
``__byte_perm``, a barrier only in the 2-D gather) were redesigned for the
H100.  This study builds another checkout's kernels from that checkout's own sources
and times both on the same inputs, in turns (earlier, this, this,
earlier), so that one call on one card compares them:

    git archive <commit> lane_tracker_tpu_torch | tar -x -C build/parent
    python -m lane_tracker_tpu_torch.probes.filter_redesign --parent build/parent

It needs CUDA and prints one JSON row per measurement:

* ``sass``: the opcode counts of ``open_tail_kernel``,
  ``sweep_dots_kernel``, ``adaptive_mean_kernel``,
  ``channel_stage_kernel``, ``tophat_kernel``, ``dual_tophat_kernel`` and
  each ``staged_tophat_kernel`` instantiation (its lane format, quads a
  thread and CTAs an SM in the name) in this checkout's library
  (``cuobjdump --dump-sass``), and ``tophat_kernel``'s in the earlier
  checkout's (``earlier: true``);
* ``row``: the filter wrappers of the main path (``tophat_ellipse`` k=29
  and ``tophat_riders`` k=55, unchanged, as a control of the spread;
  ``thr_merge_open`` k=35 with keep) on the corridor channels of the 64
  stills (assets/stills_720p.npz), the second attempt's ``merge_open`` on
  its two adaptive thresholds and ``adaptive_mean`` at its k=15 and k=35
  (each launch alone, the two, and each on one frame as 'cond' calls
  it), 10 calls a run;
* ``fused``: ``channel_stage`` on R, on LAB-B with the noise mask, and
  ``channel_stage_pyr`` on R, each checkout at its planned tiles;
* ``part``: this checkout alone, where the fused stage's time goes: B
  without the noise mask, B and R under a 1-pixel threshold, and the
  unfused ``lt_tophat`` at both k;
* ``sweep_dots``: probe 6's three kinds at the probe's size;
* ``tophat``: ``lt_tophat`` at k=29 and k=55 on probe 5's input,
  (32, 1100, 1080) ``default_rng(1)`` frames;
* ``staged``: probe 5's ``tophat_staged`` rows (bf16 k=29 and k=55, f32
  k=29) on that input, with each row's tile plan and the shared bytes a
  staged pixel;
* ``dual``: probe 10's ``dual_tophat`` on its input, the warped R and
  LAB-B of the stills cycled to 128 frames; ``dual_vs_separate``: this
  checkout's dual (``ms``) in turns with this checkout's two
  ``tophat_ellipse`` calls (``other_ms``, named by ``other``; no earlier
  kernel runs in this row);
* ``filter_stage``: the whole attempt-1 filter (``ops.filters.
  filter_stage``, the ``lt.filter`` range of a chunk) on the fail16
  chunk's channels (every 16th frame black);
* ``chain``: every runnable shift-chain variant on its probe input
  (1104, 1280), K = 64, with this checkout's kernel launches a call (the
  library's own count), each call's device time with the calls queued
  behind a spin kernel (``timing.queued_ms``), and this checkout's call
  with no pass (``k0_ms``: the lines staged in and out alone);
* ``sass_chain``: the counts of ``BAR.SYNC``, ``SHFL``, ``LDS`` and
  ``STS`` (and all instructions) in each shift-chain kernel instance of
  both checkouts (the instance's template arguments in its name: type,
  body, boundary, axis and, in this checkout, its mode: 0 orbit order in
  one warp, 1 plain order across warps, 2 plain order in one warp);
* ``tile_gather``: probe 11's four ops on its (128, 1280) input, each at
  16 and 64 reps, in turns with the earlier checkout's kernel on one timer
  (``timing.queued_ms``, as ``probes.mosaic.gather_rows``), and
  ``tile_gather_ns_per_rep``: each op's ns a rep, (t(64) - t(16)) / 48,
  for both checkouts;
* ``sass_gather``: the counts of ``BAR.SYNC``, ``SHFL``, ``LDS``, ``STS``
  and ``PRMT`` (and all instructions) in each op's ``tile_gather_kernel``
  instance of both checkouts.

With ``--probes-only`` it times the ``tophat``, ``staged``, ``dual``,
``chain`` and ``tile_gather`` rows alone: the quick way to hold a patched
copy of this checkout, as ``--parent``, against this one.

Every output of the earlier kernels must equal this checkout's (probe 6's
``out`` within ``sweep_dots.RTOL``), or the study raises.  The earlier
checkout's entries must take this checkout's arguments (those of commit
456ebbe and later); its staged and dual tophats may write their eroded
images to the scratch arguments, which ``earlier_staged`` and
``earlier_dual`` pass.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from lane_tracker_tpu_torch.calib.io import load_calibration_npz
from lane_tracker_tpu_torch.kernels import channel_fused as cf
from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.kernels import shift_chain as sc
from lane_tracker_tpu_torch.kernels import sweep_dots as sd
from lane_tracker_tpu_torch.kernels import tile_gather as tg
from lane_tracker_tpu_torch.kernels.build import build, find_nvcc
from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.timing import cuda_ms, queued_ms
from lane_tracker_tpu_torch.tracker.config import PRESETS, SECOND_ATTEMPT
from lane_tracker_tpu_torch.tracker.step import TrackerParams, warp_channels

REPO = pathlib.Path(__file__).resolve().parents[2]
T = 64
FAIL_EVERY = 16
REPS = 10

_SASS_LINE = re.compile(
    r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


@functools.lru_cache(maxsize=None)
def sass_functions(path) -> dict:
    """{function: [opcode, ...]} of a cubin or shared library's SASS."""
    res = subprocess.run(
        [str(pathlib.Path(find_nvcc()).with_name("cuobjdump")),
         "--dump-sass", str(path)], capture_output=True, text=True,
        timeout=300, check=True)
    funcs, name = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _SASS_LINE.match(line)
        if name and m:
            funcs[name].append(m.group(1))
    return funcs


def opcode_counts(lib_path, kernel: str) -> dict:
    """{opcode: count} over the functions whose mangled name holds
    ``kernel``."""
    hist = {}
    for name, ops in sass_functions(str(lib_path)).items():
        if kernel in name:
            for op in ops:
                hist[op] = hist.get(op, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def other_library(tree: pathlib.Path):
    """(library, nvcc seconds) of another checkout's kernels, built by
    that checkout's own build module from its own sources into its own
    build directory."""
    path = tree / "lane_tracker_tpu_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location("other_kernel_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, seconds, _ = mod.build()
    return mod.load_library(), seconds


def on_library(lib):
    """A context in which the filter-stage, fused-stage, probe 6,
    shift-chain and probe 11 wrappers launch ``lib``'s entries (the
    earlier checkout's interfaces are this one's)."""
    stack = contextlib.ExitStack()
    for mod in (fs, sd, cf, sc, tg):
        stack.enter_context(mock.patch.object(mod, "load_library",
                                              lambda: lib))
    return stack


def _flat(out):
    """The tensors of a wrapper's output, prefixes unpacked."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(getattr(o, "packed", o))]


def _equal(got, want, rtol) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g.dtype == torch.float32 and rtol:
            if not torch.allclose(g, w, rtol=rtol, atol=0):
                return False
        elif not torch.equal(g, w):
            return False
    return True


def in_turns(fn, lib, reps=REPS, rtol=0.0, earlier=None,
             other=None, timer=cuda_ms) -> dict:
    """{"ms", "earlier_ms"}: fn on this checkout's kernels and on ``lib``'s
    (or ``earlier``, the same function called on ``lib``'s entries
    directly), earlier, this, this, earlier; the outputs must be equal
    (float32 outputs within rtol where it is given).  With ``other``, a
    label, ``earlier`` is a comparator of this checkout's own: its time
    is "other_ms" and the label "other"."""
    def run_earlier(n):
        if earlier is not None:
            return timer(earlier, n) if n else earlier()
        with on_library(lib):
            return timer(fn, n) if n else fn()

    want = [t.clone() for t in _flat(run_earlier(0))]
    if not _equal(_flat(fn()), want, rtol):
        raise RuntimeError("the earlier kernels' output differs")
    key = "other_ms" if other else "earlier_ms"
    times = {"ms": [], key: []}
    for k in (key, "ms", "ms", key):
        times[k].append(run_earlier(reps) if k == key else timer(fn, reps))
    return {**{k: sum(v) / len(v) for k, v in times.items()},
            **({"other": other} if other else {})}


def earlier_staged(lib, img, k, code):
    """The earlier checkout's ``lt_tophat_staged`` (stage code 1 bf16, 2
    f32), with the scratch image it may use."""
    T_, H, W = img.shape
    out, scratch = torch.empty_like(img), torch.empty_like(img)
    runs = fs._runs_table(int(k))
    fs._call(img.device, lib.lt_tophat_staged,
             img.data_ptr(), out.data_ptr(), scratch.data_ptr(),
             runs.ctypes.data, len(runs), int(k), T_, H, W, int(code))
    return out


def earlier_dual(lib, a, b, ka, kb):
    """The earlier checkout's ``lt_dual_tophat``, with its scratch
    images."""
    T_, H, W = a.shape
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    sa, sb = torch.empty_like(a), torch.empty_like(b)
    runs_a, runs_b = fs._runs_table(int(ka)), fs._runs_table(int(kb))
    fs._call(a.device, lib.lt_dual_tophat,
             a.data_ptr(), b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
             sa.data_ptr(), sb.data_ptr(), runs_a.ctypes.data, len(runs_a),
             int(ka), runs_b.ctypes.data, len(runs_b), int(kb), T_, H, W)
    return out_a, out_b


def probe_rows(lib, emit) -> None:
    """The ``tophat``, ``staged``, ``dual`` and ``dual_vs_separate``
    rows."""
    from lane_tracker_tpu_torch.probes import mosaic

    img = mosaic.probe_frames(mosaic.TOPHAT_T, "cuda")
    for k in (29, 55):
        emit({"tophat": f"lt_tophat k={k}", "shape": list(img.shape),
              **in_turns(lambda k=k: fs.tophat_ellipse(img, k), lib)})
    _, H, W = img.shape
    for name, k, dtype in mosaic.PROBE5:
        code = fs.STAGING[dtype]
        plan = fs.tophat_plan(k, H, W, dtype.itemsize)
        staged = ((plan["th"] + 4 * (k // 2))
                  * (plan["tq"] + 4 * plan["rq"]) * 16 // dtype.itemsize)
        emit({"staged": name, "shape": list(img.shape), "plan": plan,
              "smem_bytes_per_staged_pixel": plan["smem"] / staged,
              **in_turns(lambda k=k, dtype=dtype: fs.tophat_staged(
                  img, k, dtype), lib,
                  earlier=lambda k=k, code=code: earlier_staged(
                      lib, img, k, code))})
    del img
    r, b = mosaic.warped_channels(mosaic.DUAL_T, "cuda")
    ka, kb = mosaic.DUAL_K
    emit({"dual": "dual_tophat", "shape": list(r.shape),
          **in_turns(lambda: fs.dual_tophat(r, b, ka, kb), lib,
                     earlier=lambda: earlier_dual(lib, r, b, ka, kb))})
    emit({"dual_vs_separate": "dual_tophat", "shape": list(r.shape),
          **in_turns(lambda: fs.dual_tophat(r, b, ka, kb), lib,
                     earlier=lambda: (fs.tophat_ellipse(r, ka),
                                      fs.tophat_ellipse(b, kb)),
                     other="two tophat_ellipse calls")})


CHAIN_OPS = ("BAR.SYNC", "SHFL", "LDS", "STS")
CHAIN_KERNELS = ("shift_chain_kernel", "elementwise_kernel", "chain2d_kernel",
                 "chain2d_fast_kernel")


def chain_sass(lib_path) -> dict:
    """{function: {op: count}} of the shift chains' kernel instances: the
    barriers, shuffles and shared loads and stores (opcodes by prefix)."""
    rows = {}
    for name, ops in sass_functions(str(lib_path)).items():
        if any(k in name for k in CHAIN_KERNELS):
            rows[name] = {op: sum(o.startswith(op) for o in ops)
                          for op in CHAIN_OPS}
            rows[name]["instructions"] = len(ops)
    return rows


def earlier_chain2d(lib, x, v, bar):
    """``bf16_morph_chain8`` on the earlier checkout's
    ``lt_shift_chain_2d``, with the scratch its cooperative kernel may use
    (commit 5c12960 and before): p and q, and ``bar``, two int32 zeroed
    once (its grid barrier leaves the arrival count at 0)."""
    h, w = x.shape
    out, p, q = (torch.empty_like(x) for _ in range(3))
    a1, a2 = v.shifts
    fs._call(x.device, lib.lt_shift_chain_2d,
             x.data_ptr(), out.data_ptr(), p.data_ptr(), q.data_ptr(),
             bar.data_ptr(), h, w, v.n_passes(), a1 % w, a2 % w, a1 % h,
             a2 % h)
    return out


def chain_rows(lib, emit) -> None:
    """The ``chain`` rows: every runnable shift-chain variant on its probe
    input (1104, 1280), K = 64, in turns with the earlier checkout's
    kernels, with this checkout's kernel launches a call."""
    bar = torch.zeros(2, dtype=torch.int32, device="cuda")
    for v in sc.VARIANTS:
        if v.rejected:
            continue
        x = sc.make_input(v, device="cuda")
        before = fs.kernel_launches()
        sc.shift_chain(x, v)
        launches = fs.kernel_launches() - before
        earlier = None
        if v.body == "morph_chain8":
            earlier = lambda x=x, v=v: earlier_chain2d(lib, x, v, bar)  # noqa: E731
        row = {"chain": v.name, "shape": list(x.shape), "k": sc.K,
               "kernel_launches": launches,
               **in_turns(lambda x=x, v=v: sc.shift_chain(x, v), lib,
                          earlier=earlier, timer=queued_ms)}
        if v.body != "morph_chain8":
            # the same call with no pass: staging in and out alone
            row["k0_ms"] = queued_ms(lambda x=x, v=v: sc.shift_chain(x, v, 0),
                                     REPS)
        emit(row)


GATHER_OPS = ("BAR.SYNC", "SHFL", "LDS", "STS", "PRMT")


def gather_sass(lib_path) -> dict:
    """{op: {opcode: count}} of each op's ``tile_gather_kernel`` instance
    (its template argument, the op's code, in the mangled name)."""
    rows = {}
    for name, ops in sass_functions(str(lib_path)).items():
        for op, code in tg.OPS.items():
            if f"tile_gather_kernelILi{code}E" in name:
                rows[op] = {o: sum(x.startswith(o) for x in ops)
                            for o in GATHER_OPS}
                rows[op]["instructions"] = len(ops)
    return rows


def gather_rows(lib, emit) -> None:
    """The ``tile_gather`` rows: each op at both chain lengths in turns with
    the earlier checkout's kernel, queued behind a spin kernel, then each
    op's ns a rep in both checkouts."""
    src, li, si = tg.make_inputs("cuda")
    for op in tg.OPS:
        ms = {}
        for n in tg.REPS:
            row = in_turns(lambda op=op, n=n: tg.tile_gather(src, li, si, op,
                                                             n),
                           lib, timer=queued_ms)
            ms[n] = row
            emit({"tile_gather": op, "reps": n, "shape": list(src.shape),
                  **row})
        lo, hi = tg.REPS
        emit({"tile_gather_ns_per_rep": op, **{
            key.replace("ms", "ns"): (ms[hi][key] - ms[lo][key]) * 1e6
            / (hi - lo) for key in ("ms", "earlier_ms")}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout of the earlier package (git archive "
                    "<commit> lane_tracker_tpu_torch, unpacked)")
    ap.add_argument("--probes-only", action="store_true",
                    help="time the tophat, staged, dual, chain and "
                    "tile_gather rows alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("filter_redesign needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]

    def emit(row):
        print(json.dumps({**row, "card": card}), flush=True)

    lib_path, nvcc_s, _ = build()
    lib, other_s = other_library(args.parent.resolve())
    emit({"build_s": nvcc_s, "earlier_build_s": other_s})
    # tophat_kernel by its mangled length prefix: the staged and dual
    # kernels' names hold it too.
    for kernel in ("open_tail_kernel", "sweep_dots_kernel",
                   "adaptive_mean_kernel", "channel_stage_kernel",
                   "13tophat_kernel", "dual_tophat_kernel"):
        emit({"sass": kernel, "opcodes": opcode_counts(lib_path, kernel)})
    for name in sass_functions(str(lib_path)):
        if "staged_tophat_kernel" in name:
            emit({"sass": name, "opcodes": opcode_counts(lib_path, name)})
    emit({"sass": "13tophat_kernel", "earlier": True,
          "opcodes": opcode_counts(lib._name, "13tophat_kernel")})
    for tree, path in (("this", lib_path), ("earlier", lib._name)):
        for name, counts in chain_sass(path).items():
            emit({"sass_chain": name, "tree": tree, **counts})
        for op, counts in gather_sass(path).items():
            emit({"sass_gather": op, "tree": tree, **counts})
    if args.probes_only:
        gather_rows(lib, emit)
        probe_rows(lib, emit)
        chain_rows(lib, emit)
        return 0

    with np.load(REPO / "assets" / "stills_720p.npz") as z:
        stills = z["frames"]
    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor")
    f = PRESETS["demo1"].filter
    f2 = SECOND_ATTEMPT.filter
    chunk = torch.from_numpy(stills[np.arange(T) % len(stills)]).cuda()
    r, b = warp_channels(chunk, params)
    r_feat = fs.tophat_ellipse(r, f.tophat_r)
    riders = [(r_feat, f.ksize_r, f.C_r, -1),
              (b, f.ksize_noise, f.C_noise, f.noise_thresh)]
    b_feat, r_th, keep = fs.tophat_riders(b, f.tophat_b, riders)
    r_am = fs.adaptive_mean(r, f2.ksize_r, -f2.C_r)
    b_am = fs.adaptive_mean(b, f2.ksize_b, -f2.C_b)
    rows = {
        "tophat_ellipse": lambda: fs.tophat_ellipse(r, f.tophat_r),
        "tophat_riders": lambda: fs.tophat_riders(b, f.tophat_b, riders),
        "thr_merge_open": lambda: fs.thr_merge_open(
            r_th, b_feat, f.ksize_b, f.C_b, keep, open_k=f.open_k),
        "merge_open": lambda: fs.merge_open(r_am, b_am, open_k=f2.open_k),
    }
    am = [(r, f2.ksize_r, -f2.C_r), (b, f2.ksize_b, -f2.C_b)]
    for args in am:
        rows[f"adaptive_mean k={args[1]}"] = (
            lambda args=args: fs.adaptive_mean(*args))
    rows["adaptive_mean, both"] = lambda: [fs.adaptive_mean(*a) for a in am]
    for name, fn in rows.items():
        emit({"row": name, "shape": list(r.shape), **in_turns(fn, lib)})
    # 'cond' runs the fallback on one failing frame at a time.
    for x, k, C in am:
        x1 = x[:1].contiguous()
        emit({"row": f"adaptive_mean k={k}", "shape": list(x1.shape),
              **in_turns(lambda x1=x1, k=k, C=C: fs.adaptive_mean(x1, k, C),
                         lib)})
    del r_am, b_am
    noise = (f.ksize_noise, f.C_noise, f.noise_thresh)
    W_ = r.shape[-1]
    fused = {
        "channel_stage R": lambda: cf.channel_stage(r, f.tophat_r, f.ksize_r,
                                                    f.C_r),
        "channel_stage B + noise": lambda: cf.channel_stage(
            b, f.tophat_b, f.ksize_b, f.C_b, noise=noise),
        "channel_stage_pyr R": lambda: cf.channel_stage_pyr(
            r, f.tophat_r, f.ksize_r, f.C_r),
    }
    # Where the fused stage's time goes (this tree alone, planned tiles):
    # B without its noise mask and each channel under a 1-pixel threshold
    # (its tophat with almost no threshold halo), beside the unfused
    # tophats.
    parts = {
        "channel_stage B, no noise": (b, f.tophat_b, f.ksize_b, f.C_b),
        "channel_stage B, kb=1": (b, f.tophat_b, 1, f.C_b),
        "channel_stage R, kb=1": (r, f.tophat_r, 1, f.C_r),
    }
    for name, (x, kt, kb, C) in parts.items():
        emit({"part": name, "tile": list(cf.tile(x.shape[1], W_, kt, kb)),
              "ms": cuda_ms(lambda: cf.channel_stage(x, kt, kb, C), REPS)})
    for x, kt in ((r, f.tophat_r), (b, f.tophat_b)):
        emit({"part": f"lt_tophat k={kt}",
              "ms": cuda_ms(lambda: fs.tophat_ellipse(x, kt), REPS)})
    for name, fn in fused.items():
        emit({"fused": name, "shape": list(r.shape),
              **in_turns(fn, lib, reps=3)})
    x, tri = sd.make_inputs(device="cuda")
    for kind in sd.KINDS:
        emit({"sweep_dots": kind, "shape": list(x.shape),
              **in_turns(lambda kind=kind: sd.sweep_dots(x, tri, kind), lib,
                         rtol=sd.RTOL)})
    del x, tri
    gather_rows(lib, emit)
    probe_rows(lib, emit)
    chain_rows(lib, emit)
    fail = chunk.clone()
    fail[::FAIL_EVERY] = 0
    rf, bf = warp_channels(fail, params)
    emit({"filter_stage": f"fail{FAIL_EVERY}", "shape": list(rf.shape),
          **in_turns(lambda: filter_stage(rf, bf, f), lib)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
