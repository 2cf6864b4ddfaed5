"""Frame sources and sinks for the video CLI (process_video.py).

Copied from lane_tracker_tpu/io/video.py:1-258 (host numpy);
tests/test_torch_host.py pins the npz source and sink equal.

The reference drives its frame loop through MoviePy's ffmpeg subprocess
pipes (process_video.py:42-44: decode -> process() -> encode).  This module
provides the same role with three interchangeable backends, all exposing a
chunked iterator interface sized for the device pipeline:

* :class:`FfmpegSource`/:class:`FfmpegSink` — raw RGB24 frames over pipes
  to an ``ffmpeg`` binary (gated: used when ffmpeg is on PATH).
* :class:`ImageDirSource`/:class:`ImageDirSink` — numbered image files
  (any format PIL/imageio can read; gated on those libraries).
* :class:`NpzSource`/:class:`NpzSink` — raw uint8 frame stacks, dependency
  free, used by tests and benchmarks.

Sources yield (T, H, W, 3) uint8 chunks (last chunk padded, with a valid
count) so the device pipeline always sees chunks of one shape.
"""

from __future__ import annotations

import importlib
import pathlib
import shutil
import subprocess

import numpy as np


class FrameSource:
    """Iterable of (chunk, n_valid) with chunk (T, H, W, 3) uint8."""

    size: tuple  # (W, H)
    fps: float

    def chunks(self, chunk_size: int):
        raise NotImplementedError

    def close(self):
        pass


class FrameSink:
    def write(self, frames: np.ndarray, n_valid: int | None = None):
        raise NotImplementedError

    def close(self):
        pass


def _pad_chunk(frames, chunk_size):
    n = len(frames)
    if n == 0:
        return None
    arr = np.stack(frames)
    if n < chunk_size:
        pad = np.repeat(arr[-1:], chunk_size - n, axis=0)
        arr = np.concatenate([arr, pad], axis=0)
    return arr, n


# ---------------------------------------------------------------------------
# ffmpeg pipes


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


class FfmpegSource(FrameSource):
    """Decode any container/codec ffmpeg understands into raw RGB frames."""

    def __init__(self, path, size=None):
        if not have_ffmpeg():
            raise RuntimeError("ffmpeg binary not found on PATH")
        probe = subprocess.run(
            [
                "ffprobe", "-v", "error", "-select_streams", "v:0",
                "-show_entries", "stream=width,height,r_frame_rate",
                "-of", "csv=p=0", str(path),
            ],
            capture_output=True,
            text=True,
            check=True,
        )
        w, h, rate = probe.stdout.strip().split(",")[:3]
        num, den = rate.split("/")
        self.size = (int(w), int(h))
        self.fps = float(num) / float(den)
        self._proc = subprocess.Popen(
            [
                "ffmpeg", "-v", "error", "-i", str(path),
                "-f", "rawvideo", "-pix_fmt", "rgb24", "-",
            ],
            stdout=subprocess.PIPE,
        )

    def chunks(self, chunk_size: int):
        W, H = self.size
        nbytes = W * H * 3
        buf = []
        while True:
            raw = self._proc.stdout.read(nbytes)
            if len(raw) < nbytes:
                break
            buf.append(np.frombuffer(raw, np.uint8).reshape(H, W, 3))
            if len(buf) == chunk_size:
                yield np.stack(buf), chunk_size
                buf = []
        tail = _pad_chunk(buf, chunk_size)
        if tail:
            yield tail

    def close(self):
        if self._proc.stdout:
            self._proc.stdout.close()
        self._proc.wait()


class FfmpegSink(FrameSink):
    def __init__(self, path, size, fps=25.0):
        if not have_ffmpeg():
            raise RuntimeError("ffmpeg binary not found on PATH")
        W, H = size
        self._proc = subprocess.Popen(
            [
                "ffmpeg", "-y", "-v", "error", "-f", "rawvideo",
                "-pix_fmt", "rgb24", "-s", f"{W}x{H}", "-r", str(fps),
                "-i", "-", "-pix_fmt", "yuv420p", str(path),
            ],
            stdin=subprocess.PIPE,
        )

    def write(self, frames, n_valid=None):
        n = len(frames) if n_valid is None else n_valid
        for f in np.asarray(frames)[:n]:
            self._proc.stdin.write(np.ascontiguousarray(f, np.uint8).tobytes())

    def close(self):
        self._proc.stdin.close()
        self._proc.wait()


# ---------------------------------------------------------------------------
# image directories


def _pil_image():
    """PIL's Image module, imported only where an image directory is
    read or written."""
    try:
        Image = importlib.import_module("PIL.Image")
    except ImportError as e:
        raise ImportError(
            "image directories need Pillow (PIL), which is not installed; "
            "use an .npz, .rgb24 or video file instead") from e
    return Image


class ImageDirSource(FrameSource):
    """Read sorted image files from a directory (PIL-gated)."""

    def __init__(self, path, pattern="*"):
        Image = _pil_image()  # gated import

        self._Image = Image
        self.files = sorted(
            p
            for p in pathlib.Path(path).glob(pattern)
            if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp")
        )
        if not self.files:
            raise FileNotFoundError(f"no images under {path}")
        first = np.asarray(Image.open(self.files[0]).convert("RGB"))
        self.size = (first.shape[1], first.shape[0])
        self.fps = 25.0

    def chunks(self, chunk_size: int):
        buf = []
        for p in self.files:
            buf.append(np.asarray(self._Image.open(p).convert("RGB")))
            if len(buf) == chunk_size:
                yield np.stack(buf), chunk_size
                buf = []
        tail = _pad_chunk(buf, chunk_size)
        if tail:
            yield tail


class ImageDirSink(FrameSink):
    def __init__(self, path, prefix="frame"):
        Image = _pil_image()

        self._Image = Image
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self._i = 0

    def write(self, frames, n_valid=None):
        n = len(frames) if n_valid is None else n_valid
        for f in np.asarray(frames)[:n]:
            self._Image.fromarray(f).save(
                self.dir / f"{self.prefix}{self._i:06d}.png"
            )
            self._i += 1


# ---------------------------------------------------------------------------
# raw npz stacks (dependency-free)


class NpzSource(FrameSource):
    def __init__(self, path, key="frames"):
        self._z = np.load(path)
        self._frames = self._z[key]
        self.size = (self._frames.shape[2], self._frames.shape[1])
        self.fps = 25.0

    def chunks(self, chunk_size: int):
        n = len(self._frames)
        for i in range(0, n, chunk_size):
            part = self._frames[i : i + chunk_size]
            arr, k = _pad_chunk(list(part), chunk_size)
            yield arr, k


class NpzSink(FrameSink):
    def __init__(self, path):
        self.path = path
        self._parts = []

    def write(self, frames, n_valid=None):
        n = len(frames) if n_valid is None else n_valid
        self._parts.append(np.asarray(frames)[:n].copy())

    def close(self):
        frames = (
            np.concatenate(self._parts)
            if self._parts
            else np.zeros((0, 1, 1, 3), np.uint8)
        )
        np.savez_compressed(self.path, frames=frames)


# ---------------------------------------------------------------------------


def open_source(path) -> FrameSource:
    p = pathlib.Path(path)
    if p.is_dir():
        return ImageDirSource(p)
    if p.suffix == ".npz":
        return NpzSource(p)
    if p.suffix == ".rgb24":
        from lane_tracker_tpu_torch.io.native_loader import RawRGB24Source

        return RawRGB24Source(p)
    return FfmpegSource(p)


def open_sink(path, size, fps=25.0) -> FrameSink:
    p = pathlib.Path(path)
    if p.suffix == ".npz":
        return NpzSink(p)
    if p.suffix == ".rgb24":
        from lane_tracker_tpu_torch.io.native_loader import RawRGB24Sink

        return RawRGB24Sink(p, size, fps)
    if p.suffix in (".mp4", ".avi", ".mkv", ".mov", ".webm"):
        return FfmpegSink(p, size, fps)
    return ImageDirSink(p)
