"""The port's chunk pipeline against JAX ``chunk_process`` at full size.

demo1, pipeline 'corridor' on the 1280x720 calibration, the four stills
cycled to T=8, second_attempt='two_phase'; JAX runs its XLA filter chain.
The port's params and states are made on the CPU (``device="cpu"``; its
entry points default to the card).  A second chunk starts both packages
from the JAX package's mid-stream state (``state_from_numpy``) and params
(``params_from_jax``).  The fail16
chunk is the same cycle with every 16th frame black (bench.py's
BENCH_FAIL_EVERY=16) from a fresh state: frames 0 and 1 fail attempt 1,
and the chunk takes two_phase's fallback.

Tolerances: decision fields identical; coefficient curves within 0.01 px
RMSE of JAX; overlays within 1 unit (the count is printed); the validity
trace equals ``assets/bench_oracle.npz`` (``bench_oracle_fail16.npz``)
and the curves are within 0.5 px RMSE of its coefficients on frames valid
in both (bench.py's gate).
"""

import numpy as np
import pytest
import torch

import jax

from tests.conftest import ASSETS_DIR
from tests.test_torch_pipeline import (
    INT_STATE,
    assert_outputs_match,
    curve_rmse,
    port_config,
)

from lane_tracker_tpu.calib.io import load_calibration_npz
from lane_tracker_tpu.parallel.pipeline import chunk_process as j_chunk
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

from lane_tracker_tpu_torch.parallel.pipeline import chunk_process as t_chunk
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.state import state_from_numpy

T = 8


def _calib_args():
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    return (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)


@pytest.fixture(scope="module")
def full():
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        stills = z["frames"]
    frames = stills[np.arange(T) % 4]
    args = _calib_args()
    jp = j_step.TrackerParams.build(*args, pipeline="corridor",
                                    filter_backend="xla")
    tp = t_step.TrackerParams.build(*args, pipeline="corridor",
                                    device="cpu")
    cfg = PRESETS["demo1"]
    run = jax.jit(lambda s, f, p: j_chunk(s, f, p, cfg, True,
                                          second_attempt="two_phase"))
    j_state, jo = run(j_step.make_initial_state(cfg, jp.warped_size), frames,
                      jp)
    t_state, to = t_chunk(
        t_step.make_initial_state(cfg, tp.warped_size, "cpu"),
        torch.from_numpy(frames), tp, port_config(cfg),
        second_attempt="two_phase")
    return frames, cfg, jp, run, (j_state, jo), (t_state, to)


def test_full_chunk_matches_jax(full):
    _, _, jp, _, (j_state, jo), (t_state, to) = full
    assert_outputs_match(jo, to, jp.warped_size[1])
    for f in INT_STATE:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)),
                                      err_msg=f)


def assert_matches_oracle(to, name, H):
    """bench.py's gate: the validity trace equals the oracle's, the
    corridor certificate holds, and the curves are within 0.5 px RMSE of
    the oracle's on frames valid in both."""
    oracle = np.load(ASSETS_DIR / name)
    valid = to.valid.numpy()
    np.testing.assert_array_equal(valid, oracle["valid"][:len(valid)])
    assert to.corridor_ok.all()
    rs = [curve_rmse(m, r, H)
          for t in range(len(valid)) if valid[t] and oracle["valid"][t]
          for m, r in ((to.left_coeffs[t].numpy(), oracle["left"][t]),
                       (to.right_coeffs[t].numpy(), oracle["right"][t]))]
    print(f"rmse_px_max vs {name}: {max(rs)}")
    assert max(rs) <= 0.5


def test_full_chunk_matches_bench_oracle(full):
    _, _, jp, _, _, (_, to) = full
    assert_matches_oracle(to, "bench_oracle.npz", jp.warped_size[1])


@pytest.fixture(scope="module")
def fail16(full):
    frames, cfg, jp, run, _, _ = full
    frames = frames.copy()
    frames[::16] = 0
    tp = t_step.TrackerParams.build(*_calib_args(), pipeline="corridor",
                                    device="cpu")
    jo = run(j_step.make_initial_state(cfg, jp.warped_size), frames, jp)
    to = t_chunk(t_step.make_initial_state(cfg, tp.warped_size, "cpu"),
                 torch.from_numpy(frames), tp, port_config(cfg),
                 second_attempt="two_phase")
    return jp, jo, to


def test_fail16_chunk_matches_jax(fail16):
    jp, (j_state, jo), (t_state, to) = fail16
    np.testing.assert_array_equal(np.asarray(jo.a1_valid)[:2], [False, False])
    np.testing.assert_array_equal(to.n_attempts.numpy(),
                                  np.where(to.a1_valid.numpy(), 1, 2))
    assert_outputs_match(jo, to, jp.warped_size[1])
    for f in INT_STATE:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)),
                                      err_msg=f)


def test_fail16_chunk_matches_bench_oracle(fail16):
    jp, _, (_, to) = fail16
    assert not to.valid.numpy()[:2].any()
    assert_matches_oracle(to, "bench_oracle_fail16.npz", jp.warped_size[1])


def test_mid_stream_chunk_from_jax_state_and_params(full):
    frames, cfg, jp, run, (j_state, _), _ = full
    frames2 = np.ascontiguousarray(frames[:4])  # the cycle continues
    j_state2, jo2 = run(j_state, frames2, jp)
    assert np.asarray(jo2.a1_valid).all()
    tp = t_step.params_from_jax(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)],
        jp.tree_flatten()[1], device="cpu")
    t_state2, to2 = t_chunk(
        state_from_numpy(type(j_state)(*map(np.asarray, j_state)), "cpu"),
        torch.from_numpy(frames2), tp, port_config(cfg),
        second_attempt="two_phase")
    assert_outputs_match(jo2, to2, jp.warped_size[1])
    assert (to2.search_mode.numpy() == 1).all()
    for f in INT_STATE:
        np.testing.assert_array_equal(getattr(t_state2, f).numpy(),
                                      np.asarray(getattr(j_state2, f)),
                                      err_msg=f)
