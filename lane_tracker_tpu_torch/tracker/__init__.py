"""The tracker: its configuration, state, per-frame step and the
stateful ``tracker.LaneTracker``."""

from lane_tracker_tpu_torch.tracker.config import (
    PRESETS,
    SECOND_ATTEMPT,
    FilterConfig,
    SearchConfig,
    TrackerConfig,
    ValidityConfig,
)

__all__ = [
    "TrackerConfig",
    "FilterConfig",
    "SearchConfig",
    "ValidityConfig",
    "PRESETS",
    "SECOND_ATTEMPT",
]
