"""The port's 'half' pipeline against the JAX package's, on the CPU.

'half' (lane_tracker_tpu/tracker/step.py:193-214) runs the whole warped
space at half resolution: M scaled by the half-resolution pixel-centre map,
Minv by its inverse, the warped size 540x550, m/px doubled, and the
config's px-denominated knobs halved (``halve_config``; the second
attempt ``SECOND_ATTEMPT_HALF``).  Held at full size (the helpers and
tolerances of tests/torch_modes.py):

* the params: every grid, ``fwd_u`` / ``fwd_v``, the sizes and m/px equal
  JAX's, and ``params_from_jax`` gives the same params;
* ``warp_channels`` on the stills and a black frame: R bit-exact, LAB-B
  within the warp contract;
* ``chunk_process`` at T=8 from a fresh state (two_phase, a black frame,
  so the halved second attempt runs), and in 'hoist' and 'cond';
* ``LaneTracker.process`` over tests/test_torch_tracker.py's schedule:
  the decisions, the diagnostics transcript (narrated in the half-size
  space) line for line, snapshots continued across the packages both
  ways, and the search pictures exactly equal to JAX's drawn from the
  binary its tracker searched: JAX's picture module is patched here to
  pass the halved structuring elements (15, 27, 3) its ``viz.py`` leaves
  at the reference's (29, 55, 5) and to take ``SECOND_ATTEMPT_HALF``;
  unpatched, 2.5% of its picture's values differ;
* the halved filters' reach (``filter_reach``), and a two-stream fleet
  equal to the chunk on each stream.
"""

import numpy as np
import pytest
import torch

import jax

from tests import torch_modes as tm
from tests.test_torch_filter_reach import filter_reach

import lane_tracker_tpu.render.viz as j_viz
from lane_tracker_tpu.tracker.config import SECOND_ATTEMPT_HALF as J_SA_HALF

from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
from lane_tracker_tpu_torch.tracker import step as t_step

PIPELINE = "half"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return tm.build_both(PIPELINE)


def test_params_equal_jax(params):
    jp, tp = params
    args = tm.calib_args()
    assert tp.res_scale == jp.res_scale == 2
    assert tp.warped_size == jp.warped_size == (540, 550)
    assert (tp.mppv, tp.mpph) == (jp.mppv, jp.mpph) == (2 * args[6],
                                                       2 * args[7])
    assert tp.raw_roi == jp.raw_roi
    for name in ("grid_und_roi", "grid_warp_roi"):
        jg, tg = getattr(jp, name), getattr(tp, name)
        assert tg.src_size == jg.src_size and tg.dst_shape == jg.base.shape
        for k in ("base", "w00", "w01", "w10", "w11"):
            np.testing.assert_array_equal(
                getattr(tg, k).numpy(), np.asarray(getattr(jg, k)).reshape(-1),
                err_msg=f"{name}.{k}")
    np.testing.assert_array_equal(tp.fwd_u.numpy(), np.asarray(jp.fwd_u))
    np.testing.assert_array_equal(tp.fwd_v.numpy(), np.asarray(jp.fwd_v))
    fp = t_step.params_from_jax(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)],
        jp.tree_flatten()[1], device="cpu")
    assert (fp.res_scale, fp.warped_size, fp.mppv) == (2, (540, 550), tp.mppv)
    for k, v in dict(tp.named_buffers()).items():
        assert torch.equal(dict(fp.named_buffers())[k], v), k


def test_warp_channels_match_jax(params):
    jp, tp = params
    frames = np.concatenate([tm.stills(), np.zeros_like(tm.stills()[:1])])
    tr, _ = tm.assert_warp_channels_match(jp, tp, frames)
    assert tuple(tr.shape) == (5, 550, 540)


@pytest.fixture(scope="module")
def chunks():
    return tm.run_chunks(PIPELINE)


def test_chunk_matches_jax(chunks, params):
    tm.assert_chunks_match(*chunks, params[1].warped_size[1])


@pytest.mark.parametrize("mode", ["hoist", "cond"])
def test_chunk_modes_equal_two_phase(chunks, params, mode):
    """The halved second attempt in each schedule: every output equal."""
    _, tp = params
    _, tcfg = tm.configs(PIPELINE)
    _, (_, want) = chunks
    _, got = chunk_process(
        t_step.make_initial_state(tcfg, tp.warped_size, "cpu"),
        torch.from_numpy(tm.chunk_frames()), tp, tcfg, second_attempt=mode)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _halved_elements(fn):
    """JAX's channel filter with the halved configs' structuring elements
    (demo1's and SECOND_ATTEMPT's alike halve to 15, 27 and 3)."""
    def call(*args, **kw):
        return fn(*args, tophat_r=15, tophat_b=27, open_k=3, **kw)

    return call


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_viz, "filter_lane_points_channels",
                   _halved_elements(j_viz.filter_lane_points_channels))
        mp.setattr(j_viz, "SECOND_ATTEMPT", J_SA_HALF)
        return tm.drive_both(PIPELINE, tmp_path_factory.mktemp(PIPELINE))


def test_process_matches_jax(drives):
    _, j, t = drives
    tm.assert_process_matches(j, t)
    assert any("Using band search." in lines for lines in t["lines"])
    for i in (0, 5):
        assert t["pictures"][i].shape == (550, 540, 3)
        np.testing.assert_array_equal(t["pictures"][i], j["pictures"][i])
    assert t["pictures"][2].shape == j["pictures"][2].shape


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_continues_in_the_other_package(drives, direction):
    tm.assert_snapshot_continues(PIPELINE, drives, direction)


def test_rows_and_fleet_equal_unsharded(params):
    """The halved filters' reach, and a two-stream fleet over two CPU
    devices equal to ``chunk_process`` on each stream's frames."""
    _, tp = params
    _, tcfg = tm.configs(PIPELINE)
    # The halved filters reach 2 * 13 + 17 + 2 * 1 rows.
    assert filter_reach(tcfg.filter) == 45
    frames = tm.chunk_frames()[1:5]  # frame 2 is black
    tm.assert_fleet_equals_chunks(tp, tcfg, np.stack([frames[:2],
                                                      frames[2:]]))
