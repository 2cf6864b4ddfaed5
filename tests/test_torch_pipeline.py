"""The port's chunk pipeline against JAX ``chunk_process``: tiny geometry.

A synthetic 128x96 calibration and the tiny config (as
tests/test_parallel.py), pipeline 'corridor' with an explicit col_roi,
T=6.  Both packages start from a fresh state, the port's made on the CPU
(``device="cpu"``; the port's entry points default to the card) and run
with the JAX params (``params_from_jax``).  A chunk with a black frame takes the second
attempt, in each of the ``second_attempt`` modes.

Tolerances: decision fields identical (valid, detected, search_mode,
n_points_*, corridor_ok, render_mode, n_attempts, a1_*); coefficient
curves within 0.01 px RMSE; overlays within 1 unit; integer state fields
identical.  Also pinned: an unknown mode raises ``ValueError``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from lane_tracker_tpu.calib.synthetic import make_synthetic_calibration, tiny_config
from lane_tracker_tpu.parallel.pipeline import chunk_process as j_chunk
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import ValidityConfig

from lane_tracker_tpu_torch.parallel.pipeline import chunk_process as t_chunk
from lane_tracker_tpu_torch.tracker import config as t_cfg
from lane_tracker_tpu_torch.tracker.step import (
    make_initial_state,
    params_from_jax,
)

DECISIONS = ("valid", "detected", "search_mode", "n_points_left",
             "n_points_right", "corridor_ok", "render_mode", "n_attempts",
             "a1_valid", "a1_detected")
INT_STATE = ("last_detection", "hist_valid", "has_avg", "rn_left", "rn_right",
             "rfirst_left", "rfirst_right", "counter", "success")


def port_config(cfg) -> t_cfg.TrackerConfig:
    """The port's TrackerConfig with the same field values."""
    return t_cfg.TrackerConfig(
        filter=t_cfg.FilterConfig(**dataclasses.asdict(cfg.filter)),
        search=t_cfg.SearchConfig(**dataclasses.asdict(cfg.search)),
        validity=t_cfg.ValidityConfig(**dataclasses.asdict(cfg.validity)),
        n_tries=cfg.n_tries, n_fail=cfg.n_fail, n_reset=cfg.n_reset,
        n_average=cfg.n_average)


def curve_rmse(a, b, H):
    yy = np.arange(H, dtype=np.float64)
    return np.sqrt(np.mean((np.polyval(np.asarray(a, float), yy)
                            - np.polyval(np.asarray(b, float), yy)) ** 2))


def assert_outputs_match(jo, to, H, overlay=True):
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    for side in ("left_coeffs", "right_coeffs"):
        for a, b in zip(getattr(to, side).numpy(),
                        np.asarray(getattr(jo, side))):
            assert curve_rmse(a, b, H) <= 0.01, side
    if overlay:
        d = np.abs(to.overlay.numpy().astype(int)
                   - np.asarray(jo.overlay).astype(int))
        print(f"overlay: {int((d != 0).sum())} of {d.size} values differ")
        assert d.max() <= 1


def lane_frames(n, H=96, W=128, seed=0):
    """Synthetic frames: two bright converging stripes drifting by 1 px
    per frame over dark noise."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(20, 60, (n, H, W, 3), dtype=np.uint8)
    for t in range(n):
        for xfrac in (0.40, 0.60):
            for y in range(H // 2, H):
                depth = (y - H // 2) / (H / 2)
                x = int(W / 2 + (xfrac - 0.5) * W * depth) + t - n // 2
                frames[t, y, max(x - 1, 0):min(x + 2, W), :] = 230
    return frames


def assert_states_match(j_state, t_state):
    for f in INT_STATE:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def tiny():
    cam, warp = make_synthetic_calibration(img_size=(128, 96),
                                           warped_size=(96, 128))
    permissive = ValidityConfig(
        min_dist_y1=0, max_dist_y1=10_000, min_dist_y2=0, max_dist_y2=10_000,
        min_dist_y3=0, max_dist_y3=10_000, tangent_thresh=1e9)
    cfg = tiny_config().replace(n_tries=2, validity=permissive)
    jp = j_step.TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor", col_roi=(16, 80),
        filter_backend="xla")
    tp = params_from_jax([np.asarray(x) for x in jax.tree_util.tree_leaves(jp)],
                         jp.tree_flatten()[1], device="cpu")
    return cfg, jp, tp


def _run_both(tiny, frames, mode):
    """JAX and the port on one chunk from a fresh state, in one mode."""
    cfg, jp, tp = tiny
    j_state, jo = jax.jit(lambda s, f, p: j_chunk(
        s, f, p, cfg, True, second_attempt=mode))(
            j_step.make_initial_state(cfg, jp.warped_size), frames, jp)
    t_state, to = t_chunk(make_initial_state(cfg, tp.warped_size, "cpu"),
                          torch.from_numpy(frames), tp, port_config(cfg),
                          second_attempt=mode)
    return (j_state, jo), (t_state, to)


def test_tiny_chunk_matches_jax(tiny):
    frames = lane_frames(6, seed=2)
    (j_state, jo), (t_state, to) = _run_both(tiny, frames, "two_phase")
    assert (np.asarray(jo.search_mode) == 1).any()
    assert_outputs_match(jo, to, tiny[1].warped_size[1])
    assert_states_match(j_state, t_state)


@pytest.mark.parametrize("mode", ["two_phase", "hoist", "cond", None])
def test_black_frame_second_attempt_matches_jax(tiny, mode):
    """Frame 3 is black: attempt 1 fails and the second attempt runs (and
    fails too); the next frames recover.  Every mode equals JAX's."""
    frames = lane_frames(6, seed=2)
    frames[3] = 0
    (j_state, jo), (t_state, to) = _run_both(tiny, frames, mode)
    assert not np.asarray(jo.a1_valid)[3]
    np.testing.assert_array_equal(
        np.asarray(jo.n_attempts), np.where(np.asarray(jo.a1_valid), 1, 2))
    assert_outputs_match(jo, to, tiny[1].warped_size[1])
    assert_states_match(j_state, t_state)


def test_unknown_second_attempt_mode_raises(tiny):
    cfg, _, tp = tiny
    with pytest.raises(ValueError, match="unknown second_attempt"):
        t_chunk(make_initial_state(cfg, tp.warped_size, "cpu"),
                torch.from_numpy(lane_frames(2)), tp, port_config(cfg),
                second_attempt="both")
