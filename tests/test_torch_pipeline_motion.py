"""The port's chunk pipeline against JAX ``chunk_process`` on the motion
frames.

Frames 0-7 of ``scripts/motion_longrun.motion_sequence`` (bench.py's
BENCH_MOTION=1 chunk: the corpus stills under a slowly varying affine
jitter, cv2 ``warpAffine`` with reflected borders; every frame unique, so
band search follows real motion), demo1, pipeline 'corridor',
second_attempt='two_phase', both packages from a fresh state; JAX on its
XLA filter chain, the port on the CPU (its kernels' plain twins).

Tolerances: decision fields identical, so the port's validity trace
equals JAX's; coefficient curves within 0.01 px RMSE of JAX; overlays
within 1 unit (the count is printed); the integer state identical.
Against ``assets/bench_oracle_motion.npz[:8]`` (the live reference's
trace of these frames) both packages' RMSE figures are printed and the
port's may be no worse than JAX's plus 0.01 px.  bench.py's 0.5 px gate
does not apply here: the reference's own motion maximum is 0.7572 px
(docs/PERFORMANCE.md, the motion oracle's knife-edge frames).
"""

import os

import numpy as np
import pytest

from tests.conftest import ASSETS_DIR
from tests.test_torch_pipeline import assert_outputs_match, curve_rmse
from tests.test_torch_pipeline_presets import (
    T,
    assert_render_matches,
    assert_state_matches,
    run_full_chunk,
)
from tests.torch_scripts import REPO, load_script

from lane_tracker_tpu.tracker.config import PRESETS


def motion_frames(n=T):
    """The motion generator's first n frames (it opens ``assets/`` by a
    path relative to the repo root)."""
    here = os.getcwd()
    os.chdir(REPO)
    try:
        gen = load_script("motion_longrun").motion_sequence(n)
        return np.stack([f for _, f in gen])
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def motion():
    frames = motion_frames()
    assert frames.shape == (T, 720, 1280, 3)
    assert len({f.tobytes() for f in frames}) == T  # every frame unique
    return run_full_chunk(PRESETS["demo1"], frames, "corridor")


def oracle_rmse(outs, oracle, H):
    """The largest curve RMSE against the oracle over the frames valid in
    both."""
    valid = np.asarray(outs.valid)
    return max(curve_rmse(np.asarray(m[t]), r[t], H)
               for t in range(len(valid))
               if valid[t] and oracle["valid"][t]
               for m, r in ((outs.left_coeffs, oracle["left"]),
                            (outs.right_coeffs, oracle["right"])))


def test_motion_chunk_matches_jax(motion):
    assert (np.asarray(motion.jo.search_mode) == 1).any()  # band search ran
    assert_outputs_match(motion.jo, motion.to, motion.H)


def test_motion_state_matches_jax(motion):
    assert_state_matches(motion.j_state, motion.t_state)


def test_motion_chunk_against_oracle(motion):
    jo, to, H = motion.jo, motion.to, motion.H
    with np.load(ASSETS_DIR / "bench_oracle_motion.npz") as z:
        oracle = {k: z[k][:T] for k in ("valid", "left", "right")}
    np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
    j_rmse = oracle_rmse(jo, oracle, H)
    t_rmse = oracle_rmse(to, oracle, H)
    off = int((to.valid.numpy() != oracle["valid"]).sum())
    print(f"motion[:{T}] rmse_px_max vs bench_oracle_motion.npz: "
          f"port {t_rmse}, JAX {j_rmse}; validity off the oracle on "
          f"{off} of {T} frames")
    assert t_rmse <= j_rmse + 0.01


def test_motion_render_matches_jax(motion):
    assert_render_matches(motion)
