"""Tracker configuration: frozen dataclasses of static knobs.

Copied from lane_tracker_tpu/tracker/config.py (FilterConfig,
SearchConfig, ValidityConfig, TrackerConfig, SECOND_ATTEMPT, PRESETS);
tests/test_torch_host.py pins every field equal to the original.  The
'half' pipeline's halve_config is not carried over: the port builds only
'fast' and 'corridor'.

``PRESETS`` carries the known-good per-video parameter sets of the
reference's tracker_settings.md ('demo1', 'demo2', 'demo3') plus
'committed' (the validity thresholds committed in the reference source).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Knobs of the filter stage (lane_tracker.py:183-240)."""

    filter_type: str = "bilateral"  # 'bilateral' | 'neighborhood'
    ksize_r: int = 15
    C_r: int = 8
    ksize_b: int = 35
    C_b: int = 5
    mask_noise: bool = False
    noise_thresh: int = 140
    ksize_noise: int = 65
    C_noise: int = 10
    # Structuring-element sizes.  The reference hardcodes 29/55/5
    # (lane_tracker.py:203-205, 234-238).
    tophat_r: int = 29
    tophat_b: int = 55
    open_k: int = 5


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Knobs of the sliding-window and band searches
    (lane_tracker.py:242-500)."""

    window_width: int = 30
    window_height: int = 40
    search_range: int = 20
    mu: float = 0.1
    no_success_limit: int = 8
    start_slice: float = 0.25
    ignore_sides: int = 360
    ignore_bottom: int = 30
    bandwidth: int = 25
    partial: float = 1.0


@dataclasses.dataclass(frozen=True)
class ValidityConfig:
    """Lane-pair plausibility thresholds (lane_tracker.py:588-593, 617).

    ``y_eval_from_width`` preserves the reference quirk of deriving the three
    probe y-values from ``warped_size[0]`` (the WIDTH) instead of the height
    (lane_tracker.py:571-573).  Set it False for the geometrically correct
    behavior.
    """

    min_dist_y1: float = 150.0
    max_dist_y1: float = 230.0
    min_dist_y2: float = 110.0
    max_dist_y2: float = 230.0
    min_dist_y3: float = 80.0
    max_dist_y3: float = 200.0
    tangent_thresh: float = 0.25
    y_eval_from_width: bool = True


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Everything LaneTracker needs besides the calibration artifacts."""

    filter: FilterConfig = FilterConfig()
    search: SearchConfig = SearchConfig()
    validity: ValidityConfig = ValidityConfig()
    n_tries: int = 2
    # State-machine policy (constructor tier, lane_tracker.py:114-121):
    n_fail: int = 8
    n_reset: int = 4
    n_average: int = 2

    def replace(self, **kw) -> "TrackerConfig":
        return dataclasses.replace(self, **kw)


# The hardcoded second-attempt parameter set (lane_tracker.py:1081-1099).
SECOND_ATTEMPT = TrackerConfig(
    filter=FilterConfig(
        filter_type="neighborhood",
        ksize_r=15,
        C_r=5,
        ksize_b=35,
        C_b=5,
        mask_noise=False,
        noise_thresh=140,
        ksize_noise=65,
        C_noise=10,
    ),
    search=SearchConfig(
        window_width=30,
        window_height=40,
        search_range=20,
        mu=0.1,
        no_success_limit=50,
        start_slice=0.25,
        ignore_sides=360,
        ignore_bottom=30,
        bandwidth=30,
        partial=1.0,
    ),
)


def _demo(filter_kw, search_kw, validity_kw, n_tries):
    return TrackerConfig(
        filter=FilterConfig(**filter_kw),
        search=SearchConfig(**search_kw),
        validity=ValidityConfig(**validity_kw),
        n_tries=n_tries,
    )


PRESETS = {
    # process() defaults + committed validity thresholds (= Demo-Video-2
    # thresholds, per tracker_settings.md:67-72 and lane_tracker.py:588-593).
    "committed": TrackerConfig(),
    # tracker_settings.md:1-34
    "demo1": _demo(
        dict(ksize_r=15, C_r=8, mask_noise=True),
        dict(no_success_limit=50, bandwidth=30),
        dict(
            min_dist_y1=150,
            max_dist_y1=245,
            min_dist_y2=150,
            max_dist_y2=255,
            min_dist_y3=150,
            max_dist_y3=255,
        ),
        n_tries=2,
    ),
    # tracker_settings.md:36-73
    "demo2": _demo(
        dict(ksize_r=20, C_r=5, mask_noise=False),
        dict(no_success_limit=50, bandwidth=30),
        dict(
            min_dist_y1=150,
            max_dist_y1=230,
            min_dist_y2=110,
            max_dist_y2=230,
            min_dist_y3=80,
            max_dist_y3=200,
        ),
        n_tries=1,
    ),
    # tracker_settings.md:75-111
    "demo3": _demo(
        dict(ksize_r=15, C_r=8, mask_noise=True),
        dict(no_success_limit=50, bandwidth=30, partial=0.5),
        dict(
            min_dist_y1=150,
            max_dist_y1=245,
            min_dist_y2=140,
            max_dist_y2=265,
            min_dist_y3=125,
            max_dist_y3=290,
            tangent_thresh=0.46,
        ),
        n_tries=2,
    ),
}
