"""The resampling gathers and the hand-written CUDA kernels' wrappers.

As the reference's ``lane_tracker_tpu.kernels``: the resampling grid and
its gathers.  The reference's ``filter_stage_v2`` (the Pallas filter
stage) is ``ops.filters.filter_stage`` here, over the kernels of
``kernels/filter_stage.py``.
"""

from lane_tracker_tpu_torch.kernels.resample import (
    ResampleGrid,
    bilinear_gather,
    bilinear_gather_pair,
)

__all__ = [
    "ResampleGrid",
    "bilinear_gather",
    "bilinear_gather_pair",
]
