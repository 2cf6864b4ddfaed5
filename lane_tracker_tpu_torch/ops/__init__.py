"""The tracker's operators on tensors (plain PyTorch; the filter stage's
kernels live in ``kernels/``).

The names of the reference's ``lane_tracker_tpu.ops`` resolve here.  They
load on first use (PEP 562): ``ops.filters`` imports the filter kernels'
wrappers, which import ``ops.integrals``, so importing ``ops.filters``
while this package initialises would import a half-made module.
"""

import importlib

import numpy as np


def f32(v) -> float:
    """A Python float holding exactly the float32 rounding of ``v``.

    Scalar operands of float32 tensor arithmetic are passed this way so
    each equals the reference's ``jnp.float32`` constant whatever precision
    the backend converts scalars in."""
    return float(np.float32(v))


_SOURCE = {
    "rgb2lab_u8": "color",
    "rgb2lab_b_u8": "color",
    "bilateral_adaptive_threshold": "threshold",
    "adaptive_mean_threshold": "threshold",
    "in_range": "threshold",
    "erode_ellipse": "morphology",
    "dilate_ellipse": "morphology",
    "open_ellipse": "morphology",
    "tophat_ellipse": "morphology",
    "ellipse_runs": "morphology",
    "filter_lane_points": "filters",
}

__all__ = list(_SOURCE)


def __getattr__(name):
    if name in _SOURCE:
        return getattr(importlib.import_module(f"{__name__}.{_SOURCE[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
