"""Build and load the port's CUDA kernels (nvcc -> .so -> ctypes).

The sources under ``lane_tracker_tpu_torch/csrc/`` have a plain C
interface and include no PyTorch header, so ``nvcc`` builds each in
seconds: one ``nvcc -c`` per source, all started together, then one link
into a shared library.  The library is built at first use into
``build/lt_torch_kernels/`` beside the package (a directory git ignores),
named by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lt_torch_kernels"
SOURCES = ("filter_stage.cu", "tophat_staged.cu", "dual_tophat.cu",
           "adaptive_mean.cu", "channel_stage.cu", "resample_mxu2.cu",
           "shift_chain.cu", "shift_chain_8bit.cu", "shift_chain_i16.cu",
           "shift_chain_i32.cu", "shift_chain_bf16.cu", "sweep_dots.cu",
           "tile_gather.cu")
HEADERS = ("common.cuh", "tophat.cuh", "shift_chain.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# Every pointer and the stream are c_void_p, every int is c_int, every
# double c_double.
SIGNATURES = {
    "lt_tophat": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lt_cross_threshold": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lt_thr_merge_open": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P),
    "lt_merge_open": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lt_open_prefix": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lt_adaptive_mean": (_P, _P, _I, _I, _I, _I, _I, _P),
    "lt_channel_stage": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P),
    "lt_channel_stage_plan": (_P, _I, _I, _I, _I, _I, _I, _I),
    "lt_banded_pass2": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lt_tophat_staged": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lt_tophat_plan": (_P, _I, _I, _I, _I, _I, _P),
    "lt_dual_tophat": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I,
                       _I, _I, _P),
    "lt_shift_chain": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _D,
                       _D, _P),
    "lt_shift_chain_2d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    "lt_shift_chain_plan": (_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "lt_sweep_dots": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P),
    "lt_tile_gather": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "lt_filter_stage_launches": (),
}
# Entries that return something else than an int error code.
RESTYPES = {"lt_filter_stage_launches": ctypes.c_longlong}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"liblt_filter_stage_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the sources if their library is missing.

    Returns (path, seconds spent compiling, nvcc's messages); seconds is 0
    when an up-to-date library already existed.  The messages end each
    source's with a line of its own seconds ("nvcc -c <source>: <s> s").
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{pathlib.Path(src).stem}.o" for src in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")

    def compile_one(src, obj):
        t = time.perf_counter()
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return res, time.perf_counter() - t

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            done = list(pool.map(compile_one, SOURCES, objs))
        log = "".join(f"{res.stdout}nvcc -c {src}: {sec:.1f} s\n"
                      for src, (res, sec) in zip(SOURCES, done))
        failed = [src for src, (res, _) in zip(SOURCES, done)
                  if res.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out, seconds, log


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry's ctypes signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib
