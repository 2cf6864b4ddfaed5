"""A chunk of host frames onto the device a slice at a time, under the warp.

``LaneTracker.process_chunk`` hands ``parallel.pipeline.chunk_process`` a
:class:`StreamedChunk` in place of a device tensor when its frames are
on the host.  The front half (``tracker.step.front_artifacts_batch``)
walks :meth:`StreamedChunk.slices` and warps each slice as it lands;
everything after the warp reads the whole device chunk,
``StreamedChunk.frames``.

On the card the chunk reaches the device in slices of about
``SLICE_BYTES``.  Each slice is copied on the host, by torch's threaded
``copy_``, into one of two page-locked buffers (:class:`Staging`, the
tracker's, reused from chunk to chunk), then copied without blocking to
its frames of the device chunk on the staging's copy stream; the compute
stream waits for that copy's event on the card, not on the host, before
it runs the slice's warp.  The host stays a slice ahead of the card: it
stages slice 0, then after queueing the warp of slice ``s`` it stages
slice ``s + 1``, first waiting for the copy that last read the buffer
(slice ``s - 1``'s, which the warp of ``s - 1`` already waited for).  So
only slice 0's copy is exposed; each other slice's staging and copy run
under the warp of the slice before it.  Each slice's staging is one
``lt.upload`` span, a sibling of the ``lt.warp_lab`` spans, and counts
its frames in ``lt.upload.streamed_frames``.

On the CPU the chunk is copied whole in one ``lt.upload`` span, and
``slices`` yields views of it: the same per-slice warp runs, and nothing
is counted.
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.utils.profiling import count, span

# Bytes of frames a slice: 36 frames at 1280x720, a 27 ms warp in 'fast'.
SLICE_BYTES = 96 << 20


def slice_frames(frame_bytes: int) -> int:
    """Frames a slice: ``SLICE_BYTES`` of frames of ``frame_bytes`` bytes,
    at least one."""
    return max(1, SLICE_BYTES // frame_bytes)


class Staging:
    """A tracker's two page-locked slice buffers, its copy stream, and the
    event of the copy that last read each buffer."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.buffers: list[torch.Tensor] = []
        self.read: list[torch.cuda.Event | None] = [None, None]

    def fit(self, frames: int, frame_shape: tuple) -> None:
        """Buffers that hold ``frames`` frames of ``frame_shape``: kept
        where they do, else allocated anew (the pinned allocator keeps an
        old buffer until the copies that read it have run)."""
        if (self.buffers and self.buffers[0].shape[0] >= frames
                and tuple(self.buffers[0].shape[1:]) == tuple(frame_shape)):
            return
        self.buffers = [torch.empty((frames,) + tuple(frame_shape),
                                    dtype=torch.uint8, pin_memory=True)
                        for _ in range(2)]

    def take(self, i: int, frames: int) -> torch.Tensor:
        """The first ``frames`` frames of buffer ``i``, once the copy that
        last read it has run (a wait on the host)."""
        if self.read[i] is not None:
            self.read[i].synchronize()
        return self.buffers[i][:frames]


class StreamedChunk:
    """A (T, H, W, 3) uint8 chunk of host frames on its way to ``device``
    (module docstring).  ``frames`` is the device chunk, whole once
    :meth:`slices` has been walked to its end; ``staging`` is None off the
    card."""

    def __init__(self, host: np.ndarray, device: torch.device,
                 staging: Staging | None):
        self.host = host
        self.shape = host.shape
        T = host.shape[0]
        k = min(T, slice_frames(int(np.prod(host.shape[1:]))))
        self.bounds = [(lo, min(lo + k, T)) for lo in range(0, T, max(1, k))]
        self.staging = staging
        if staging is None:
            with span("lt.upload"):
                self.frames = torch.tensor(host, device=device)
            return
        self.frames = torch.empty(host.shape, dtype=torch.uint8,
                                  device=device)
        # The compute stream is the chunk's device's current stream, on
        # which every operation of the chunk queues: the copies write
        # memory it may have used until now, and the allocator must not
        # hand that memory on under a copy.
        with torch.cuda.device(self.frames.device):
            free = torch.cuda.Event()
            free.record()
        staging.stream.wait_event(free)
        self.frames.record_stream(staging.stream)
        staging.fit(k, host.shape[1:])
        self._landed: list[torch.cuda.Event] = []

    def _stage(self, s: int) -> None:
        """Copy slice ``s`` into its pinned buffer and queue its copy to
        the device on the copy stream."""
        lo, hi = self.bounds[s]
        st = self.staging
        with span("lt.upload"):
            buf = st.take(s % 2, hi - lo)
            buf.copy_(torch.from_numpy(np.ascontiguousarray(
                self.host[lo:hi])))
            with torch.cuda.stream(st.stream):
                self.frames[lo:hi].copy_(buf, non_blocking=True)
            st.read[s % 2] = st.stream.record_event()
            self._landed.append(st.read[s % 2])
            count("lt.upload.streamed_frames", hi - lo)

    def slices(self):
        """Yield ``(lo, frames[lo:hi])`` for each slice in order, each
        landed on the device before the work queued for it on the compute
        stream."""
        if self.staging is None:
            for lo, hi in self.bounds:
                yield lo, self.frames[lo:hi]
            return
        n = len(self.bounds)
        if n:
            self._stage(0)
        for s, (lo, hi) in enumerate(self.bounds):
            with torch.cuda.device(self.frames.device):
                self._landed[s].wait()
            yield lo, self.frames[lo:hi]
            if s + 1 < n:
                self._stage(s + 1)
