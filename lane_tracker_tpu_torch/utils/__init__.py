from lane_tracker_tpu_torch.utils.profiling import (
    FpsMeter,
    maybe_profile,
    span,
)

__all__ = ["FpsMeter", "maybe_profile", "span"]
