# Frozen copies of lane_tracker_tpu_torch/ops/__init__.py:15-21 (``f32``) and
# lane_tracker_tpu_torch/device.py:14-26 (``entry_device``) (commit 6cc3612),
# for the benchmark's plain reference.
"""Small helpers of the plain reference."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def f32(v) -> float:
    """A Python float holding exactly the float32 rounding of ``v``."""
    return float(np.float32(v))


def entry_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} asked for, but CUDA is not "
                           "available")
    return dev
