"""Device lists for stream-parallel serving.

Port of lane_tracker_tpu/parallel/mesh.py.  The reference's 1-D
``jax.sharding.Mesh`` over the 'stream' axis becomes a tuple of
``torch.device``: independent dashcam streams are the data-parallel axis,
and stream shard i lives on device i.  There is no gradient or weight
traffic; the only cross-device step is summing the fleet's metrics.

``stream_row_mesh`` is the reference's streams x image-rows mesh as
n_stream tuples of n_rows devices, kept because the reference exports
it; nothing in the port splits a frame's rows (one card holds a whole
chunk's front half), so no program consumes it.
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.device import DEFAULT_DEVICE, entry_device
from lane_tracker_tpu_torch.tracker.step import TrackerParams


def stream_mesh(n_devices: int | None = None,
                devices=None) -> tuple[torch.device, ...]:
    """The devices streams are sharded over: ``devices`` (for example
    ``("cpu", "cpu")``), else the first ``n_devices`` CUDA devices, else
    every one.  Without CUDA the default raises."""
    if devices is None:
        entry_device(DEFAULT_DEVICE)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = tuple(_indexed(entry_device(d)) for d in devices)
    if not mesh:
        raise ValueError("a stream mesh needs at least one device")
    return mesh


def stream_row_mesh(n_stream: int, n_rows: int,
                    devices=None) -> tuple[tuple[torch.device, ...], ...]:
    """``n_stream`` tuples of ``n_rows`` devices (streams x image rows):
    the first ``n_stream * n_rows`` of ``devices`` (which may repeat a
    device), else of the CUDA devices.  Without CUDA the default
    raises."""
    n = int(n_stream) * int(n_rows)
    if n < 1:
        raise ValueError(f"a {n_stream} x {n_rows} mesh has no devices")
    if devices is None:
        entry_device(DEFAULT_DEVICE)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(entry_device(d)) for d in devices]
    if len(devices) < n:
        raise ValueError(f"a {n_stream} x {n_rows} mesh needs {n} devices, "
                         f"got {len(devices)}")
    return tuple(tuple(devices[s * n_rows:(s + 1) * n_rows])
                 for s in range(n_stream))


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, so that one card has one
    name in a mesh."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def map_tensors(fn, tree):
    """``fn`` on every tensor (or numpy array) leaf of a tensor or a
    NamedTuple tree; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(tree))
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    raise TypeError(f"no tensors in a {type(tree).__name__}")


def shard_streams(tree, mesh) -> tuple:
    """One piece of ``tree`` per device of ``mesh``: every tensor (or
    numpy array) leaf split into equal pieces along its leading stream
    axis, piece i on ``mesh[i]``."""
    n = len(mesh)

    def piece(i):
        def cut(x):
            if x.shape[0] % n:
                raise ValueError(f"{x.shape[0]} streams do not divide over "
                                 f"{n} devices")
            s = x.shape[0] // n
            return x[i * s:(i + 1) * s].to(mesh[i])

        return map_tensors(cut, tree)

    return tuple(piece(i) for i in range(n))


def replicate(params: TrackerParams, mesh) -> tuple[TrackerParams, ...]:
    """One ``TrackerParams`` per device of ``mesh``: ``params`` itself
    where it already lives there, else a copy of every buffer built for
    that device (``TrackerParams.copy_to``)."""
    return tuple(params if params.fwd_u.device == torch.device(d)
                 else params.copy_to(d) for d in mesh)
