"""ctypes bindings for the native C++ frame loader (native/frame_loader.cpp).

Port of lane_tracker_tpu/io/native_loader.py:1-144 (host I/O).  The port
binds the same C++ source itself: it compiles ``native/frame_loader.cpp``
(read, never written) with the Makefile's flags into
``build/lt_frameloader/``, which git ignores, and loads it by ctypes.

Raw RGB24 stream format: ``<name>.rgb24`` holds back-to-back H*W*3 uint8
frames; geometry + fps live in a ``<name>.rgb24.json`` sidecar.  The C++
loader prefetches chunks on a background thread into a buffer ring so disk
I/O overlaps device compute.

Where the library cannot be built (no C++ compiler), a numpy memmap reader
serves the same chunk contract: that is host I/O either way, and no device
work depends on which reader ran.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import shutil
import subprocess

import numpy as np

from lane_tracker_tpu_torch.io.video import FrameSink, FrameSource, _pad_chunk

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
_SOURCE = _REPO / "native" / "frame_loader.cpp"
_SO = _REPO / "build" / "lt_frameloader" / "liblt_frameloader.so"
# native/Makefile's CXXFLAGS and link step.
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")


def build_native(force: bool = False) -> bool:
    """Compile the loader if needed. Returns True when the .so is usable."""
    if _SO.exists() and not force:
        return True
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None or not _SOURCE.exists():
        return False
    _SO.parent.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename, so processes building at once
    # never load a half-written library.
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_CXXFLAGS, str(_SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return False
    return _SO.exists()


def _load_lib():
    lib = ctypes.CDLL(str(_SO))
    lib.lt_loader_open.restype = ctypes.c_void_p
    lib.lt_loader_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.lt_loader_acquire.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.lt_loader_acquire.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.lt_loader_close.argtypes = [ctypes.c_void_p]
    return lib


def write_rgb24(path, frames: np.ndarray, fps: float = 25.0):
    """Write a (N, H, W, 3) uint8 stack as a raw .rgb24 stream + sidecar."""
    path = pathlib.Path(path)
    frames = np.ascontiguousarray(frames, np.uint8)
    with open(path, "wb") as f:
        f.write(frames.tobytes())
    sidecar = {
        "width": int(frames.shape[2]),
        "height": int(frames.shape[1]),
        "fps": float(fps),
    }
    path.with_suffix(path.suffix + ".json").write_text(json.dumps(sidecar))


class RawRGB24Source(FrameSource):
    """Chunked reader for .rgb24 streams; native-prefetched when possible."""

    def __init__(self, path, prefer_native: bool = True):
        self.path = pathlib.Path(path)
        meta = json.loads(
            self.path.with_suffix(self.path.suffix + ".json").read_text()
        )
        self.size = (int(meta["width"]), int(meta["height"]))
        self.fps = float(meta.get("fps", 25.0))
        self.native = prefer_native and build_native()
        self._handle = None
        self._lib = None

    def chunks(self, chunk_size: int):
        W, H = self.size
        if self.native:
            lib = _load_lib()
            handle = lib.lt_loader_open(
                str(self.path).encode(), W, H, chunk_size, 3
            )
            if not handle:
                raise OSError(f"native loader failed to open {self.path}")
            self._handle, self._lib = handle, lib
            n_valid = ctypes.c_int(0)
            nbytes = chunk_size * H * W * 3
            try:
                while True:
                    ptr = lib.lt_loader_acquire(handle, ctypes.byref(n_valid))
                    if not ptr or n_valid.value == 0:
                        break
                    chunk = np.ctypeslib.as_array(ptr, shape=(nbytes,)).reshape(
                        chunk_size, H, W, 3
                    )
                    # Hand out a copy: the ring slot is recycled on the next
                    # acquire, while the consumer may still hold this chunk.
                    yield chunk.copy(), int(n_valid.value)
            finally:
                lib.lt_loader_close(handle)
                self._handle = None
            return
        # Without the library: a memmap reader (same chunk contract).
        frame_bytes = H * W * 3
        mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        n_frames = mm.size // frame_bytes
        arr = mm[: n_frames * frame_bytes].reshape(n_frames, H, W, 3)
        for i in range(0, n_frames, chunk_size):
            part = [np.array(f) for f in arr[i : i + chunk_size]]
            yield _pad_chunk(part, chunk_size)


class RawRGB24Sink(FrameSink):
    def __init__(self, path, size, fps=25.0):
        self.path = pathlib.Path(path)
        self._f = open(self.path, "wb")
        self.size = tuple(size)
        self.fps = float(fps)

    def write(self, frames, n_valid=None):
        n = len(frames) if n_valid is None else n_valid
        self._f.write(np.ascontiguousarray(frames[:n], np.uint8).tobytes())

    def close(self):
        self._f.close()
        sidecar = {
            "width": int(self.size[0]),
            "height": int(self.size[1]),
            "fps": self.fps,
        }
        self.path.with_suffix(self.path.suffix + ".json").write_text(
            json.dumps(sidecar)
        )
