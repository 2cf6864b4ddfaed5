"""The redesigned filter kernels against an earlier checkout's, on the card.

``lt_tophat`` and the cross threshold (``lt_cross_threshold``, the first
launch of ``lt_thr_merge_open``) were redesigned for the H100 in place,
behind the same C interfaces.  This study builds another checkout's
kernels from that checkout's own sources and times both on the same
inputs, in turns (earlier, this, this, earlier), so that one call on one
card compares them:

    git archive <commit> lane_tracker_tpu_torch | tar -x -C build/parent
    python -m lane_tracker_tpu_torch.probes.filter_redesign --parent build/parent

It needs CUDA and prints one JSON row per measurement:

* ``sass``: the opcode counts of ``tophat_kernel`` and ``threshold_kernel``
  in this checkout's library (``cuobjdump --dump-sass``), and the
  instructions one three-way min of u8x4 words takes in four forms
  (``SIMD_PROBE``, built for sm_90a): the design's choice of min/max;
* ``row``: the filter wrappers of the main path (``tophat_ellipse`` k=29,
  ``tophat_riders`` k=55 with its two riders, ``thr_merge_open`` k=35 and
  the standalone ``bilateral_threshold`` k=65) on the corridor channels of
  the 64 stills (assets/stills_720p.npz), 10 calls a run;
* ``launch``: each tophat and threshold launch of those rows alone;
* ``filter_stage``: the whole attempt-1 filter (``ops.filters.
  filter_stage``, the ``lt.filter`` range of a chunk) on the fail16
  chunk's channels (every 16th frame black).

Every output of the earlier kernels must equal this checkout's, or the
study raises.  The earlier checkout's ``lt_tophat`` takes a scratch image
for its eroded pass (the interface before the redesign, which passes it
unused); a checkout whose interfaces differ otherwise cannot be compared.
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
from lane_tracker_tpu_torch.kernels.build import (
    ARCH_FLAGS,
    build,
    find_nvcc,
)
from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.timing import cuda_ms
from lane_tracker_tpu_torch.tracker.config import PRESETS
from lane_tracker_tpu_torch.tracker.step import TrackerParams, warp_channels

REPO = pathlib.Path(__file__).resolve().parents[2]
T = 64
FAIL_EVERY = 16
REPS = 10

# Three-way per-pixel min of u8x4 words: __vminu4 twice; Hopper's DPX
# __vimin3_u16x2 on the bytes split into 16-bit lanes (masks); the
# tophat's form, pixels in the lanes' high bytes (hi form w, lo form
# w << 8) with one byte permute to merge; and one DPX call alone.
SIMD_PROBE = r"""
#include <stdint.h>
#define K(name, expr) extern "C" __global__ void name(const uint32_t* p, \
    uint32_t* o) { const uint32_t a = p[0], b = p[1], c = p[2]; o[0] = expr; }
K(min3_vminu4, __vminu4(__vminu4(a, b), c))
K(min3_dpx_masked, __vimin3_u16x2(a & 0xff00ffu, b & 0xff00ffu, c & 0xff00ffu)
  | (__vimin3_u16x2((a >> 8) & 0xff00ffu, (b >> 8) & 0xff00ffu,
                    (c >> 8) & 0xff00ffu) << 8))
K(min3_dpx_high_bytes, __byte_perm(__vimin3_u16x2(a << 8, b << 8, c << 8),
                                   __vimin3_u16x2(a, b, c), 0x7351))
K(min3_dpx_u16x2, __vimin3_u16x2(a, b, c))
"""
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


def simd_probe_counts(build_dir: pathlib.Path) -> dict:
    """{form: instructions between its last load and its store}: what one
    three-way min of a word costs in each form of SIMD_PROBE."""
    build_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = build_dir / "simd_probe.cu", build_dir / "simd_probe.cubin"
    src.write_text(SIMD_PROBE)
    subprocess.run([find_nvcc(), *ARCH_FLAGS, "-O3", "-cubin", "-o",
                    str(cubin), str(src)], check=True, capture_output=True,
                   timeout=300)
    counts = {}
    for name, ops in sass_functions(cubin).items():
        last_load = max(i for i, op in enumerate(ops) if op.startswith("LDG"))
        store = next(i for i, op in enumerate(ops) if op.startswith("STG"))
        counts[name] = sum(
            1 for op in ops[last_load + 1:store]
            if not op.startswith(("LDC", "ULDC", "IMAD.WIDE", "MOV")))
    return counts


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
    """A context in which the filter-stage wrappers launch ``lib``'s
    entries, its ``lt_tophat`` given a scratch image."""

    def tophat(img, ksize):
        T_, H, W = img.shape
        out, scratch = torch.empty_like(img), torch.empty_like(img)
        runs = fs._runs_table(int(ksize))
        fs._check(lib.lt_tophat(
            img.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            runs.ctypes.data, len(runs), int(ksize), T_, H, W, fs._stream()),
            "lt_tophat")
        return out

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fs, "load_library", lambda: lib))
    stack.enter_context(mock.patch.object(fs, "_launch_tophat", tophat))
    return stack


def _flat(out):
    """The tensors of a wrapper's output, prefixes unpacked."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(getattr(o, "packed", o))]


def in_turns(fn, lib, reps=REPS) -> dict:
    """{"ms", "earlier_ms"}: fn on this checkout's kernels and on ``lib``'s,
    earlier, this, this, earlier; the outputs must be equal."""
    with on_library(lib):
        want = [t.clone() for t in _flat(fn())]
    got = _flat(fn())
    if len(got) != len(want) or not all(torch.equal(g, w)
                                        for g, w in zip(got, want)):
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
    emit({"sass": "tophat_kernel",
          "opcodes": opcode_counts(lib_path, "tophat_kernel")})
    emit({"sass": "threshold_kernel",
          "opcodes": opcode_counts(lib_path, "threshold_kernel")})
    emit({"sass": "three-way min of u8x4 words",
          "instructions": simd_probe_counts(lib_path.parent / "simd_probe")})

    with np.load(REPO / "assets" / "stills_720p.npz") as z:
        stills = z["frames"]
    cam, warp = load_calibration_npz(REPO / "assets" / "calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor")
    f = PRESETS["demo1"].filter
    chunk = torch.from_numpy(stills[np.arange(T) % len(stills)]).cuda()
    r, b = warp_channels(chunk, params)
    r_feat = fs.tophat_ellipse(r, f.tophat_r)
    riders = [(r_feat, f.ksize_r, f.C_r, -1),
              (b, f.ksize_noise, f.C_noise, f.noise_thresh)]
    b_feat, r_th, keep = fs.tophat_riders(b, f.tophat_b, riders)
    rows = {
        "tophat_ellipse": lambda: fs.tophat_ellipse(r, f.tophat_r),
        "tophat_riders": lambda: fs.tophat_riders(b, f.tophat_b, riders),
        "thr_merge_open": lambda: fs.thr_merge_open(
            r_th, b_feat, f.ksize_b, f.C_b, keep, open_k=f.open_k),
        "bilateral_threshold": lambda: fs.bilateral_threshold(
            b_feat, 65, f.C_b),
    }
    for name, fn in rows.items():
        emit({"row": name, "shape": list(r.shape), **in_turns(fn, lib)})
    launches = {
        f"lt_tophat k={f.tophat_r}": lambda: fs._launch_tophat(r, f.tophat_r),
        f"lt_tophat k={f.tophat_b}": lambda: fs._launch_tophat(b, f.tophat_b),
        f"lt_cross_threshold k={f.ksize_r}": lambda: fs._launch_threshold(
            r_feat, f.ksize_r, f.C_r, -1),
        f"lt_cross_threshold k={f.ksize_noise} noise mask":
            lambda: fs._launch_threshold(b, f.ksize_noise, f.C_noise,
                                         f.noise_thresh),
        f"lt_cross_threshold k={f.ksize_b}": lambda: fs._launch_threshold(
            b_feat, f.ksize_b, f.C_b, -1),
    }
    for name, fn in launches.items():
        emit({"launch": name, **in_turns(fn, lib)})
    fail = chunk.clone()
    fail[::FAIL_EVERY] = 0
    rf, bf = warp_channels(fail, params)
    emit({"filter_stage": f"fail{FAIL_EVERY}", "shape": list(rf.shape),
          **in_turns(lambda: filter_stage(rf, bf, f), lib)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
