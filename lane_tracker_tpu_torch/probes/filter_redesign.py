"""The redesigned kernels against an earlier checkout's, on the card.

Rows 3 and 5 of the filter (``thr_merge_open``, ``merge_open``: the
merge + open + prefix tail as one bit-packed kernel) and probe 6's
``sweep_dots`` (the products on wgmma) were redesigned for the H100.  This
study builds another checkout's kernels from that checkout's own sources
and times both on the same inputs, in turns (earlier, this, this,
earlier), so that one call on one card compares them:

    git archive <commit> lane_tracker_tpu_torch | tar -x -C build/parent
    python -m lane_tracker_tpu_torch.probes.filter_redesign --parent build/parent

It needs CUDA and prints one JSON row per measurement:

* ``sass``: the opcode counts of ``open_tail_kernel`` and
  ``sweep_dots_kernel`` in this checkout's library (``cuobjdump
  --dump-sass``);
* ``row``: the filter wrappers of the main path (``tophat_ellipse`` k=29
  and ``tophat_riders`` k=55, unchanged, as a control of the spread;
  ``thr_merge_open`` k=35 with keep) on the corridor channels of the 64
  stills (assets/stills_720p.npz), and the second attempt's
  ``merge_open`` on its two adaptive thresholds, 10 calls a run;
* ``sweep_dots``: probe 6's three kinds at the probe's size;
* ``filter_stage``: the whole attempt-1 filter (``ops.filters.
  filter_stage``, the ``lt.filter`` range of a chunk) on the fail16
  chunk's channels (every 16th frame black).

Every output of the earlier kernels must equal this checkout's (probe 6's
``out`` within ``sweep_dots.RTOL``), or the study raises.  The earlier
checkout's ``lt_tophat`` takes a scratch image for its eroded pass, and
its merge entries take two scratch images (the merged and the eroded
image; the interfaces before the tail's redesign); a checkout whose
interfaces differ otherwise cannot be compared.
"""

from __future__ import annotations

import argparse
import contextlib
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
from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.kernels import sweep_dots as sd
from lane_tracker_tpu_torch.kernels.build import build, find_nvcc
from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.timing import cuda_ms
from lane_tracker_tpu_torch.tracker.config import PRESETS, SECOND_ATTEMPT
from lane_tracker_tpu_torch.tracker.step import TrackerParams, warp_channels

REPO = pathlib.Path(__file__).resolve().parents[2]
T = 64
FAIL_EVERY = 16
REPS = 10

_SASS_LINE = re.compile(
    r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


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
    for name, ops in sass_functions(lib_path).items():
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
    """A context in which the filter-stage and probe 6 wrappers launch
    ``lib``'s entries, its ``lt_tophat`` given a scratch image and its
    merge entries two."""

    def tophat(img, ksize):
        T_, H, W = img.shape
        out, scratch = torch.empty_like(img), torch.empty_like(img)
        runs = fs._runs_table(int(ksize))
        fs._check(lib.lt_tophat(
            img.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            runs.ctypes.data, len(runs), int(ksize), T_, H, W, fs._stream()),
            "lt_tophat")
        return out

    def merge_entry(name, r_th, other, keep, open_k, *thr):
        T_, H, W = r_th.shape
        out, pref = torch.empty_like(r_th), fs._prefix_buffer(r_th)
        s0, s1 = torch.empty_like(r_th), torch.empty_like(r_th)
        runs = fs._runs_table(int(open_k))
        fs._check(getattr(lib, name)(
            r_th.data_ptr(), other.data_ptr(),
            None if keep is None else keep.data_ptr(), out.data_ptr(),
            pref.data_ptr(), s0.data_ptr(), s1.data_ptr(), runs.ctypes.data,
            len(runs), int(open_k), T_, H, W, *map(int, thr),
            fs._count_shift(W), fs._stream()), name)
        return out, pref

    def thr_merge_open(r_th, b_feat, keep, kb, Cb, open_k):
        return merge_entry("lt_thr_merge_open", r_th, b_feat, keep, open_k,
                           kb, Cb)

    def merge_open(r_th, b_th, keep, open_k):
        return merge_entry("lt_merge_open", r_th, b_th, keep, open_k)

    stack = contextlib.ExitStack()
    for mod in (fs, sd):
        stack.enter_context(mock.patch.object(mod, "load_library",
                                              lambda: lib))
    for name, fn in (("_launch_tophat", tophat),
                     ("_launch_thr_merge_open", thr_merge_open),
                     ("_launch_merge_open", merge_open)):
        stack.enter_context(mock.patch.object(fs, name, fn))
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


def in_turns(fn, lib, reps=REPS, rtol=0.0) -> dict:
    """{"ms", "earlier_ms"}: fn on this checkout's kernels and on ``lib``'s,
    earlier, this, this, earlier; the outputs must be equal (float32
    outputs within rtol where it is given)."""
    with on_library(lib):
        want = [t.clone() for t in _flat(fn())]
    if not _equal(_flat(fn()), want, rtol):
        raise RuntimeError("the earlier kernels' output differs")
    times = {"ms": [], "earlier_ms": []}
    for key in ("earlier_ms", "ms", "ms", "earlier_ms"):
        if key == "earlier_ms":
            with on_library(lib):
                times[key].append(cuda_ms(fn, reps))
        else:
            times[key].append(cuda_ms(fn, reps))
    return {k: sum(v) / len(v) for k, v in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="a checkout of the earlier package (git archive "
                    "<commit> lane_tracker_tpu_torch, unpacked)")
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
    for kernel in ("open_tail_kernel", "sweep_dots_kernel"):
        emit({"sass": kernel, "opcodes": opcode_counts(lib_path, kernel)})

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
    for name, fn in rows.items():
        emit({"row": name, "shape": list(r.shape), **in_turns(fn, lib)})
    del r_am, b_am
    x, tri = sd.make_inputs(device="cuda")
    for kind in sd.KINDS:
        emit({"sweep_dots": kind, "shape": list(x.shape),
              **in_turns(lambda kind=kind: sd.sweep_dots(x, tri, kind), lib,
                         rtol=sd.RTOL)})
    del x, tri
    fail = chunk.clone()
    fail[::FAIL_EVERY] = 0
    rf, bf = warp_channels(fail, params)
    emit({"filter_stage": f"fail{FAIL_EVERY}", "shape": list(rf.shape),
          **in_turns(lambda: filter_stage(rf, bf, f), lib)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
