"""The device rule of the port's entry points.

Every entry point that makes tensors (``TrackerParams.build``,
``params_from_jax``, ``make_initial_state``, ``init_state``,
``state_from_numpy``, ``MxuWarp2.build``) puts them on the card unless the
caller asks for the CPU with ``device="cpu"``.  Without CUDA the default
raises; it never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def entry_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but CUDA is not available: pass "
            f"device='cpu' to run on the CPU")
    return dev
