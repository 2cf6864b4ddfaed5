"""The benchmark's plain reference of the lane tracker.

A frozen copy of the port's plain path (``lane_tracker_tpu_torch`` at
commit 6cc3612: the calibration grids, the two-stage warp, LAB-B, the
filter stage with the CUDA kernels' plain twins, the searches, the fits,
the back half and the overlay), in plain PyTorch.  Each module names the
file and lines it was copied from.  It imports nothing of the port, of
``lane_tracker_tpu`` or of JAX, builds its own grids, params and state
from the benchmark's inputs, and runs with TF32 off.  The port's 'rowmm'
warp and its row bands are left out.

``TrackerParams.with_precision(torch.bfloat16)`` takes the warp's and
LAB-B's float sums one type down: the control of benchmark/check.py.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from benchmark.reference.calib_io import load_calibration_npz
from benchmark.reference.config import (
    FilterConfig,
    SearchConfig,
    TrackerConfig,
    ValidityConfig,
)
from benchmark.reference.pipeline import chunk_process
from benchmark.reference.state import TrackerState, state_from_numpy
from benchmark.reference.step import TrackerParams, make_initial_state


def tracker_config(settings: dict) -> TrackerConfig:
    """A TrackerConfig from a configuration file's ``tracker`` settings:
    ``filter``, ``search`` and ``validity`` groups, ``n_tries``,
    ``n_fail``, ``n_reset`` and ``n_average``."""
    return TrackerConfig(
        filter=FilterConfig(**settings["filter"]),
        search=SearchConfig(**settings["search"]),
        validity=ValidityConfig(**settings["validity"]),
        n_tries=int(settings["n_tries"]), n_fail=int(settings["n_fail"]),
        n_reset=int(settings["n_reset"]),
        n_average=int(settings["n_average"]))


def build_params(calibration, pipeline: str, device,
                 precision=torch.float32) -> TrackerParams:
    """The reference's params from a calibration ``.npz`` path."""
    cam, warp = load_calibration_npz(calibration)
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline=pipeline, device=device)
    return params.with_precision(precision)


def initial_state(config: TrackerConfig, params: TrackerParams,
                  device) -> dict:
    """A fresh state as a dict of numpy arrays."""
    return state_numpy(make_initial_state(config, params.warped_size, device))


def state_numpy(state: TrackerState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_npz_bytes(data: bytes) -> dict:
    """A state snapshot written by ``np.savez`` into memory, as a dict of
    numpy arrays."""
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in TrackerState._fields}


def run_chunk(state: dict, frames, params: TrackerParams,
              config: TrackerConfig, with_overlay: bool = True):
    """One chunk of consecutive frames of one stream from ``state`` (a dict
    of numpy arrays): returns (end state, outputs), each a dict of numpy
    arrays, the outputs with a leading T axis.  The second attempt runs
    by 'two_phase' (on the card, faster here than 'cond'); the port's
    three schedules give the same outputs."""
    dev = params.fwd_u.device
    frames = torch.as_tensor(frames).to(dev)
    st = state_from_numpy(state, dev)
    with torch.no_grad():
        st, outs = chunk_process(st, frames, params, config,
                                 with_overlay=with_overlay,
                                 second_attempt="two_phase")
    out = {k: v.detach().cpu().numpy() for k, v in outs._asdict().items()
           if v is not None}
    return state_numpy(st), out
