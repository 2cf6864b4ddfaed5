"""The port's 'fast' pipeline against JAX ``chunk_process`` at full size.

demo1, pipeline 'fast' (warp, LAB and filter over the full 1080-column
bird's-eye view), the four stills cycled to T=8, second_attempt=
'two_phase', both packages from a fresh state; JAX on its XLA filter
chain, the port on the CPU (its kernels' plain twins).  This is the path
the bench falls back to when the corridor certificate fails.

Tolerances: decision fields identical; coefficient curves within 0.01 px
RMSE of JAX; overlays within 1 unit (the count is printed); the integer
state identical; the validity trace equals ``assets/bench_oracle.npz``'s
and the curves are within 0.5 px RMSE of its coefficients (bench.py's
gate).
"""

import numpy as np
import pytest

from tests.test_torch_pipeline import assert_outputs_match
from tests.test_torch_pipeline_full import assert_matches_oracle
from tests.test_torch_pipeline_presets import (
    assert_render_matches,
    assert_state_matches,
    run_full_chunk,
    stills,
)

from lane_tracker_tpu.tracker.config import PRESETS


@pytest.fixture(scope="module")
def fast():
    return run_full_chunk(PRESETS["demo1"], stills(), "fast")


def test_fast_chunk_matches_jax(fast):
    assert_outputs_match(fast.jo, fast.to, fast.H)


def test_fast_state_matches_jax(fast):
    assert_state_matches(fast.j_state, fast.t_state)


def test_fast_chunk_matches_bench_oracle(fast):
    assert_matches_oracle(fast.to, "bench_oracle.npz", fast.H)


def test_fast_render_matches_jax(fast):
    assert_render_matches(fast)
