"""A card serving a fleet of dashcams: ``StreamFleet.step``.

``streams`` streams stepped in lockstep on one card, ``chunk_frames``
frames of each a step (``(S, T, 720, 1280, 3)`` frames on the card), each
stream's state carried from step to step, the overlay drawn for every
frame, the second attempt's schedule chosen by ``second_attempt``.
Stream s cycles through pool s of the mix.
"""

from __future__ import annotations

import numpy as np
import torch


class Entry:
    def __init__(self, cfg, mix, seed, device, root, generator, phase):
        from lane_tracker_tpu_torch import load_calibration_npz
        from lane_tracker_tpu_torch.parallel.streams import StreamFleet
        from lane_tracker_tpu_torch.tracker.config import (
            FilterConfig,
            SearchConfig,
            TrackerConfig,
            ValidityConfig,
        )
        from lane_tracker_tpu_torch.tracker.step import TrackerParams

        t = cfg["tracker"]
        self.streams = int(cfg["streams"])
        self.T = int(cfg["chunk_frames"])
        self.frames_per_unit = self.streams * self.T
        self.frames_per_call = self.streams * self.T
        self.warm_units = int(cfg.get("warm_up_units", 1))
        with phase("frames"):
            self.pools = generator.make_pools(mix, seed, self.streams, device,
                                              root)
        self.pool_frames = int(self.pools.shape[1])
        self.pool_bytes = self.pools.numel()
        with phase("params"):
            cam, warp = load_calibration_npz(root / cfg["calibration"])
            params = TrackerParams.build(
                cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
                warp.image_width_height, warp.warped_width_height, warp.mppv,
                warp.mpph, pipeline=cfg["pipeline"], device=device)
            config = TrackerConfig(
                filter=FilterConfig(**t["filter"]),
                search=SearchConfig(**t["search"]),
                validity=ValidityConfig(**t["validity"]),
                n_tries=t["n_tries"], n_fail=t["n_fail"],
                n_reset=t["n_reset"], n_average=t["n_average"])
            self.fleet = StreamFleet(
                params, config, n_streams=self.streams, mesh=[device],
                with_overlay=bool(cfg["with_overlay"]),
                second_attempt=cfg["second_attempt"])
        self.pos = 0
        self.first = None
        self.last = None

    def _index(self) -> torch.Tensor:
        idx = (self.pos + torch.arange(self.T)) % self.pool_frames
        self.pos = (self.pos + self.T) % self.pool_frames
        return idx.to(self.pools.device)

    def _states(self):
        return [type(st)(*(x.clone() for x in st)) for st in self.fleet.states]

    def _step(self):
        idx = self._index()
        outs, _ = self.fleet.step(self.pools[:, idx])
        return idx, outs

    def warm_up(self) -> None:
        """``warm_up_units`` steps from the fresh states; the first step's
        outputs are checked."""
        idx, outs = self._step()
        self.first = (None, idx, _host(outs), _host_states(self._states()))
        for _ in range(self.warm_units - 1):
            self._step()

    def unit(self) -> int:
        start = self._states()
        self.last = None
        idx, outs = self._step()
        self.last = (start, idx, outs)
        return self.frames_per_unit

    def records(self) -> list[list[dict]]:
        """The checked steps (the first, from the fresh states, and the
        window's last), each a list of per-stream records: start state (a
        dict of arrays; None: fresh), frames, outputs and end state."""
        start, idx, outs = self.last
        steps = [self.first,
                 (_host_states(start), idx, _host(outs),
                  _host_states(self._states()))]
        out = []
        for start, idx, outs, end in steps:
            out.append([{
                "start": None if start is None else _stream(start, s),
                "frames": self.pools[s, idx],
                "outs": {k: v[s] for k, v in outs.items()},
                "end": _stream(end, s)} for s in range(self.streams)])
        return out

    def release(self) -> None:
        self.fleet = None
        self.last = None


def _host(outs) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in outs._asdict().items()
            if v is not None}


def _host_states(states) -> dict:
    """One device's states (the mesh has one) as a dict of (S, ...)
    arrays."""
    (st,) = states
    return {k: v.detach().cpu().numpy() for k, v in st._asdict().items()}


def _stream(states: dict, s: int) -> dict:
    return {k: np.asarray(v[s]) for k, v in states.items()}
