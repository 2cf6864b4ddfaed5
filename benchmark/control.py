"""The check's control: the reference in the program's place, its warp and
LAB-B sums one float type down (bfloat16 for the float32 the
configuration states).  ``substitute`` swaps it into an entry, as the
program it drives: ``LaneTracker`` for entries/offline.py, ``StreamFleet``
for entries/fleet.py.  The benchmark's own runs never run it; ``run.py
--control bfloat16`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference
from benchmark.reference.state import TrackerState
from benchmark.reference.step import StepOutput


class ReferenceTracker:
    """``process_chunk`` and ``save_state`` of one stream, by the
    reference."""

    def __init__(self, params, config, device):
        self.params, self.config, self.device = params, config, device
        self.state = reference.initial_state(config, params, device)

    def process_chunk(self, frames, with_overlay=True, **_):
        self.state, outs = reference.run_chunk(
            self.state, np.asarray(frames), self.params, self.config,
            with_overlay)
        return StepOutput(**{k: torch.as_tensor(outs.get(k))
                             if k in outs else None
                             for k in StepOutput._fields})

    def save_state(self, buf) -> None:
        np.savez(buf, **self.state)


class ReferenceFleet:
    """``step`` and ``states`` of S streams, each by the reference."""

    def __init__(self, params, config, device, n_streams: int):
        self.streams = [ReferenceTracker(params, config, device)
                        for _ in range(n_streams)]

    @property
    def states(self):
        stacked = {k: torch.as_tensor(np.stack([s.state[k]
                                                for s in self.streams]))
                   for k in TrackerState._fields}
        return (TrackerState(**stacked),)

    def step(self, frames):
        outs = [s.process_chunk(frames[i].cpu().numpy())
                for i, s in enumerate(self.streams)]
        return StepOutput(*(None if fs[0] is None else torch.stack(fs)
                            for fs in zip(*outs))), {}


def substitute(entry, cfg: dict, root, device, dtype) -> None:
    params = reference.build_params(root / cfg["calibration"],
                                    cfg["pipeline"], device, dtype)
    config = reference.tracker_config(cfg["tracker"])
    if hasattr(entry, "tracker"):
        entry.tracker = ReferenceTracker(params, config, device)
    else:
        entry.fleet = ReferenceFleet(params, config, device, entry.streams)

