# Frozen copy of lane_tracker_tpu_torch/tracker/config.py:1-231 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
"""Tracker configuration: frozen dataclasses of static knobs.

Copied from lane_tracker_tpu/tracker/config.py (FilterConfig,
SearchConfig, ValidityConfig, TrackerConfig, SECOND_ATTEMPT, PRESETS, and
the 'half' pipeline's ``halve_config``, ``_odd_half`` and
``SECOND_ATTEMPT_HALF`` of config.py:128-180); tests/test_torch_host.py
pins every field and every halved config equal to the original.

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
    # (lane_tracker.py:203-205, 234-238); the 'half' pipeline scales them
    # with the warped resolution (halve_config below).
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


def _odd_half(k: int) -> int:
    """Scale an odd window/SE size to half resolution: floor-halve, then
    force odd (OpenCV kernels are odd-sized), floor 3."""
    return max(3, (k // 2) | 1)


def halve_config(cfg: TrackerConfig) -> TrackerConfig:
    """Scale a TrackerConfig to the 'half' pipeline's half-resolution
    warped space.

    Pixel-denominated knobs halve (window/SE sizes to the nearest odd,
    px distances exactly); intensity offsets (C_*, noise_thresh),
    fractions (mu, start_slice, partial), slopes (tangent_thresh,
    invariant under uniform scaling) and frame-count policies
    (n_fail/n_reset/n_average/no_success_limit/n_tries) stay put.
    """
    f, s, v = cfg.filter, cfg.search, cfg.validity
    return dataclasses.replace(
        cfg,
        filter=dataclasses.replace(
            f,
            ksize_r=_odd_half(f.ksize_r),
            ksize_b=_odd_half(f.ksize_b),
            ksize_noise=_odd_half(f.ksize_noise),
            tophat_r=_odd_half(f.tophat_r),
            tophat_b=_odd_half(f.tophat_b),
            open_k=_odd_half(f.open_k),
        ),
        search=dataclasses.replace(
            s,
            window_width=max(1, s.window_width // 2),
            window_height=max(1, s.window_height // 2),
            search_range=max(1, s.search_range // 2),
            ignore_sides=s.ignore_sides // 2,
            ignore_bottom=s.ignore_bottom // 2,
            bandwidth=max(1, s.bandwidth // 2),
        ),
        validity=dataclasses.replace(
            v,
            min_dist_y1=v.min_dist_y1 / 2,
            max_dist_y1=v.max_dist_y1 / 2,
            min_dist_y2=v.min_dist_y2 / 2,
            max_dist_y2=v.max_dist_y2 / 2,
            min_dist_y3=v.min_dist_y3 / 2,
            max_dist_y3=v.max_dist_y3 / 2,
        ),
    )


# The second-attempt set scaled for the 'half' pipeline's warped space.
SECOND_ATTEMPT_HALF = halve_config(SECOND_ATTEMPT)


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
