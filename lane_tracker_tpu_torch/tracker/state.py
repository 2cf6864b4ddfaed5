"""Tracker state: a NamedTuple of tensors threaded through the back half.

Port of lane_tracker_tpu/tracker/state.py:24-87 (same fields, same
initial values).  Ring buffers with validity masks replace the
reference's growing and popping Python lists.  Snapshots use the
reference's ``.npz`` keys (``TrackerState._fields``) and dtypes, so a
snapshot written by either package loads into the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lane_tracker_tpu_torch.device import DEFAULT_DEVICE, entry_device


class TrackerState(NamedTuple):
    last_detection: torch.Tensor  # () i32; init n_reset+1 forces sliding window
    hist_left: torch.Tensor  # (n_average, 3) f32
    hist_right: torch.Tensor  # (n_average, 3) f32
    hist_valid: torch.Tensor  # (n_average,) bool
    last_left: torch.Tensor  # (3,) f32 — latest successful fit
    last_right: torch.Tensor  # (3,) f32
    avg_left: torch.Tensor  # (3,) f32 — smoothed fit
    avg_right: torch.Tensor  # (3,) f32
    has_avg: torch.Tensor  # () bool
    rfitx_left: torch.Tensor  # (n_samples,) f32 — avg graph x at ploty samples
    rfitx_right: torch.Tensor  # (n_samples,) f32
    rn_left: torch.Tensor  # () i32 — surviving sample count
    rn_right: torch.Tensor  # () i32
    rfirst_left: torch.Tensor  # () i32 — first surviving index
    rfirst_right: torch.Tensor  # () i32
    radii: torch.Tensor  # (n_average,) f32 with -1 failure sentinels
    avg_radius: torch.Tensor  # () f32 (integer-valued)
    ecc: torch.Tensor  # () f32
    counter: torch.Tensor  # () i32
    success: torch.Tensor  # () i32


_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
           np.dtype(np.bool_): torch.bool}


def init_state(n_reset: int, n_average: int, n_samples: int,
               device=DEFAULT_DEVICE) -> TrackerState:
    """Fresh state on ``device`` (the card unless the caller passes
    ``device="cpu"``); ``n_samples`` = the warped height (render arrays
    are padded to it)."""
    device = entry_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return TrackerState(
        last_detection=torch.tensor(n_reset + 1, **i32),
        hist_left=torch.zeros((n_average, 3), **f32),
        hist_right=torch.zeros((n_average, 3), **f32),
        hist_valid=torch.zeros((n_average,), dtype=torch.bool, device=device),
        last_left=torch.zeros((3,), **f32),
        last_right=torch.zeros((3,), **f32),
        avg_left=torch.zeros((3,), **f32),
        avg_right=torch.zeros((3,), **f32),
        has_avg=torch.tensor(False, device=device),
        rfitx_left=torch.zeros((n_samples,), **f32),
        rfitx_right=torch.zeros((n_samples,), **f32),
        rn_left=torch.tensor(0, **i32),
        rn_right=torch.tensor(0, **i32),
        rfirst_left=torch.tensor(0, **i32),
        rfirst_right=torch.tensor(0, **i32),
        radii=torch.full((n_average,), -1.0, **f32),
        avg_radius=torch.tensor(0.0, **f32),
        ecc=torch.tensor(0.0, **f32),
        counter=torch.tensor(0, **i32),
        success=torch.tensor(0, **i32),
    )


def state_from_numpy(np_state, device=DEFAULT_DEVICE) -> TrackerState:
    """A TrackerState on ``device`` (the card unless the caller passes
    ``device="cpu"``) from numpy values of the same fields: a mapping, or
    any NamedTuple such as the JAX package's state after ``np.asarray``
    of every leaf."""
    device = entry_device(device)
    if not isinstance(np_state, dict):
        np_state = np_state._asdict()
    out = {}
    for name in TrackerState._fields:
        a = np.asarray(np_state[name])
        out[name] = torch.as_tensor(a.copy(), dtype=_DTYPES[a.dtype],
                                    device=device)
    return TrackerState(**out)


def state_to_npz(state: TrackerState, path) -> None:
    """Snapshot the tracker state (checkpoint/resume); the reference's
    ``state_to_npz`` (state.py:80-82): one array a field, by name."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in state._asdict().items()})


def state_from_npz(path, device=DEFAULT_DEVICE) -> TrackerState:
    """A snapshot written by either package's ``state_to_npz``, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    with np.load(path) as z:
        return state_from_numpy({k: z[k] for k in TrackerState._fields},
                                device)
