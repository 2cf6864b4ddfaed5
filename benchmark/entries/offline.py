"""Offline processing of one video: ``LaneTracker.process_chunk``.

The deployment of process_video.py, chunked: a decoded video on the host,
processed in chunks of ``chunk_frames`` consecutive frames, the tracker's
state carried from chunk to chunk, the overlay drawn for every frame.
The video is the mix's one pool, cycled.
"""

from __future__ import annotations

import io

import numpy as np

# The structuring elements process_chunk's keywords cannot set: the
# configuration must hold LaneTracker's own.
FIXED_FILTER = {"tophat_r": 29, "tophat_b": 55, "open_k": 5}


class Entry:
    streams = 1

    def __init__(self, cfg, mix, seed, device, root, generator, phase):
        from lane_tracker_tpu_torch import LaneTracker, load_calibration_npz
        from lane_tracker_tpu_torch.tracker.config import ValidityConfig

        t = cfg["tracker"]
        for k, v in FIXED_FILTER.items():
            if t["filter"][k] != v:
                raise ValueError(f"process_chunk fixes {k} at {v}")
        self.T = int(cfg["chunk_frames"])
        self.frames_per_unit = self.T
        self.frames_per_call = self.T
        with phase("frames"):
            pools = generator.make_pools(mix, seed, 1, device, root)
            self.pool = pools[0].cpu().numpy()
            del pools
        self.pool_frames = len(self.pool)
        self.pool_bytes = self.pool.nbytes
        with phase("params"):
            cam, warp = load_calibration_npz(root / cfg["calibration"])
            self.tracker = LaneTracker(
                warp.image_width_height, warp.warped_width_height,
                cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
                (warp.mppv, warp.mpph), n_fail=t["n_fail"],
                n_reset=t["n_reset"], n_average=t["n_average"],
                validity=ValidityConfig(**t["validity"]),
                pipeline=cfg["pipeline"], device=device)
        self.kwargs = {k: v for k, v in t["filter"].items()
                       if k not in FIXED_FILTER}
        self.kwargs.update(t["search"], n_tries=t["n_tries"])
        self.call = {"with_overlay": bool(cfg["with_overlay"]),
                     "second_attempt": cfg["second_attempt"]}
        self.start_frames = int(cfg["check_start_frames"])
        self.pos = 0
        self.first = None
        self.last = None

    def _frames(self) -> np.ndarray:
        P = self.pool_frames
        idx = (self.pos + np.arange(self.T)) % P
        self.pos = (self.pos + self.T) % P
        if idx[0] + self.T <= P:
            return self.pool[idx[0]:idx[0] + self.T]
        return self.pool[idx]

    def _snapshot(self) -> bytes:
        buf = io.BytesIO()
        self.tracker.save_state(buf)
        return buf.getvalue()

    def _chunk(self):
        frames = self._frames()
        outs = self.tracker.process_chunk(frames, **self.call, **self.kwargs)
        return frames, outs

    def warm_up(self) -> None:
        """One chunk from the fresh state; the outputs of its first
        ``check_start_frames`` frames are checked (a frame's outputs take
        only the frames before it)."""
        frames, outs = self._chunk()
        k = self.start_frames
        self.first = (None, frames[:k],
                      {n: v[:k] for n, v in _host(outs).items()}, None)

    def unit(self) -> int:
        start = self._snapshot()
        self.last = None
        frames, outs = self._chunk()
        self.last = (start, frames, outs)
        return self.T

    def records(self) -> list[list[dict]]:
        """The checked chunks (the start of the first, from the fresh state,
        and the window's last), each a list of one stream's record: its
        start state (None: fresh; else ``np.savez`` bytes), frames,
        outputs and end state (None: not compared), on the host."""
        start, frames, outs = self.last
        last = (start, frames, _host(outs), self._snapshot())
        return [[_record(*self.first)], [_record(*last)]]

    def release(self) -> None:
        self.tracker = None
        self.last = None


def _host(outs) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in outs._asdict().items()
            if v is not None}


def _record(start, frames, outs, end) -> dict:
    return {"start": start, "frames": frames, "outs": outs, "end": end}
