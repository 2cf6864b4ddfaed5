"""The port's chunk pipeline against JAX ``chunk_process`` on the other
presets, at full size.

Built like tests/test_torch_pipeline_full.py::test_full_chunk_matches_jax:
both packages run ``chunk_process`` from a fresh state on the same numpy
frames (the four 1280x720 stills cycled to T=8) with
second_attempt='two_phase'; JAX runs its XLA filter chain
(``filter_backend="xla"``), the port runs on the CPU (``device="cpu"``,
its kernels' plain twins).  Pipeline 'corridor' with

* demo2: ksize_r=20, no noise mask, n_tries=1;
* demo3: partial=0.5;
* committed: ``TrackerConfig()``, the reference's process() defaults.

Tolerances: decision fields identical; coefficient curves within 0.01 px
RMSE of JAX; overlays within 1 unit (the count is printed); the integer
state identical.  The renderer is held apart (demo3 here, and in the
'fast' and motion files): the chunk's overlay is exactly the port's
``render_frame`` on the port's own per-frame render inputs
(``RenderMeta``: the smoothed coefficients, the in-image sample counts,
first indices and draw flags); drawn from JAX's render inputs, the port's
overlay is JAX's within 1 unit; and the two packages' render inputs agree
(the integers identical, the smoothed curves within 0.01 px RMSE).

The fit contract reaches the overlay (demo3).  The port's fit differs
from XLA's in the last bits (its float32 reductions and 3x3 solve run in
another order; ROADMAP queue 3, "Fit"), and the direct renderer draws a
lane edge at ``trunc(polyval)`` of the smoothed fit, so where that value
lies within those bits of an integer the edge moves by one bird's-eye
column and the camera pixels under the 1-column coverage ramp change by up
to ``rint(0.3 * 255)`` = 77.  On demo3's chunk this moves 6 values of
frame 3 (one row, by 1-70).  For such presets the chunk test holds the
overlay to that bound in value, to R and B untouched, and to at most
``EDGE_VALUES_MAX`` values differing by more than 1; the render test
shows the renderer itself exact and every such value on a lane edge's
coverage ramp, in JAX's drawing or the port's, so that a lane drawn in
the wrong place, left out or taken from another frame fails.  ``run_full_chunk`` is shared with the 'fast' and motion files
(tests/test_torch_pipeline_fast.py, test_torch_pipeline_motion.py).
"""

from typing import NamedTuple

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
from tests.test_torch_pipeline_full import _calib_args

from lane_tracker_tpu.parallel import pipeline as j_pipeline
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

from lane_tracker_tpu_torch.parallel import pipeline as t_pipeline
from lane_tracker_tpu_torch.tracker import step as t_step

T = 8
# The most one bird's-eye column of a lane edge changes a camera pixel: the
# coverage ramp is one column wide and adds rint(0.3 * 255) at full cover.
EDGE_COLUMN_MAX = 77
# The most values of a chunk's overlay that may differ from JAX's by more
# than 1 at the fit contract: a few rows of one edge's ramp (6 seen).
EDGE_VALUES_MAX = 64
# Presets whose chunk meets the fit contract at a lane edge (module
# docstring); the others' overlays are held within 1 unit.
OVERLAY_AT_FIT_CONTRACT = {"demo3"}


class Run(NamedTuple):
    """One chunk through both packages from a fresh state."""

    cfg: object
    frames: np.ndarray
    jp: object  # JAX TrackerParams
    tp: object  # the port's TrackerParams (CPU)
    j_state: object
    jo: object
    t_state: object
    to: object

    @property
    def H(self):
        return int(self.jp.warped_size[1])


def stills(n=T):
    """The four stills (frame911, frame971, test4, straight_lines1)
    cycled to n frames."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        frames = z["frames"]
    return frames[np.arange(n) % len(frames)]


def run_full_chunk(cfg, frames, pipeline) -> Run:
    """JAX and the port on one chunk of ``frames`` from a fresh state."""
    args = _calib_args()
    jp = j_step.TrackerParams.build(*args, pipeline=pipeline,
                                    filter_backend="xla")
    tp = t_step.TrackerParams.build(*args, pipeline=pipeline, device="cpu")
    frames = np.ascontiguousarray(frames)
    j_state, jo = jax.jit(lambda s, f, p: j_pipeline.chunk_process(
        s, f, p, cfg, True, second_attempt="two_phase"))(
            j_step.make_initial_state(cfg, jp.warped_size), frames, jp)
    t_state, to = t_pipeline.chunk_process(
        t_step.make_initial_state(cfg, tp.warped_size, "cpu"),
        torch.from_numpy(frames), tp, port_config(cfg),
        second_attempt="two_phase")
    return Run(cfg, frames, jp, tp, j_state, jo, t_state, to)


def assert_state_matches(j_state, t_state):
    for f in INT_STATE:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)),
                                      err_msg=f)


def render_metas(run: Run):
    """Both packages' per-frame render inputs for ``run``'s chunk, from
    the same front half and two_phase scan ``chunk_process`` runs:
    (JAX's RenderMeta stack as numpy arrays, the port's)."""
    cfg = run.cfg

    def j_metas(s, f, p):
        arts = j_step.front_artifacts_batch(f, p, cfg)
        scan = (j_pipeline.two_phase_scan if t_step.has_second_attempt(cfg)
                else j_pipeline.scan_back_half)
        return scan(s, arts, p, cfg)[1][1]

    jm = jax.jit(j_metas)(j_step.make_initial_state(cfg, run.jp.warped_size),
                          run.frames, run.jp)
    tcfg = port_config(cfg)
    arts = t_step.front_artifacts_batch(torch.from_numpy(run.frames), run.tp,
                                        tcfg)
    scan = (t_pipeline.two_phase_scan if t_step.has_second_attempt(tcfg)
            else t_pipeline.scan_back_half)
    tm = scan(t_step.make_initial_state(cfg, run.tp.warped_size, "cpu"),
              arts, run.tp, tcfg)[1][1]
    fields = t_step.RenderMeta._fields
    return {f: np.asarray(getattr(jm, f)) for f in fields}, tm


@pytest.fixture(scope="module", params=["demo2", "demo3", "committed"])
def chunk(request):
    run = run_full_chunk(PRESETS[request.param], stills(), "corridor")
    print(f"{request.param}: valid {np.asarray(run.jo.valid).astype(int)}")
    return request.param, run


def test_preset_chunk_matches_jax(chunk):
    name, run = chunk
    at_contract = name in OVERLAY_AT_FIT_CONTRACT
    assert_outputs_match(run.jo, run.to, run.H, overlay=not at_contract)
    if at_contract:
        d = np.abs(run.to.overlay.numpy().astype(int)
                   - np.asarray(run.jo.overlay).astype(int))
        print(f"overlay: {int((d > 1).sum())} of {d.size} values differ by "
              f"more than 1, at most {d.max()}")
        assert not d[..., [0, 2]].any(), "R or B differs"
        assert (d > 1).sum() <= EDGE_VALUES_MAX
        assert d.max() <= EDGE_COLUMN_MAX


def test_preset_state_matches_jax(chunk):
    _, run = chunk
    assert_state_matches(run.j_state, run.t_state)


def assert_render_matches(run: Run):
    """The render inputs agree, the chunk's overlay is the port's drawing
    of its own, the port draws JAX's overlay from JAX's, and every value
    of the chunk's overlay more than 1 from JAX's lies on a lane edge's
    coverage ramp (module docstring)."""
    jm, tm = render_metas(run)
    for f in ("n_left", "n_right", "first_left", "first_right", "draw"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), jm[f],
                                      err_msg=f)
    for f in ("coeffs_left", "coeffs_right"):
        for a, b in zip(getattr(tm, f).numpy(), jm[f]):
            assert curve_rmse(a, b, run.H) <= 0.01, f
    jm = t_step.RenderMeta(*(torch.from_numpy(jm[f].copy())
                             for f in t_step.RenderMeta._fields))
    frames = torch.from_numpy(run.frames)
    cfg = port_config(run.cfg)
    own = t_step.render_frame(frames, tm, run.tp, cfg)
    assert torch.equal(own, run.to.overlay), \
        "the chunk's overlay is not the port's drawing of its render inputs"
    drawn = t_step.render_frame(frames, jm, run.tp, cfg)
    jo = np.asarray(run.jo.overlay).astype(int)
    d = np.abs(drawn.numpy().astype(int) - jo)
    print(f"overlay from JAX's render inputs: {int((d != 0).sum())} of "
          f"{d.size} values differ")
    assert d.max() <= 1
    # what each drawing adds to G, on black frames: 0 outside the lane,
    # EDGE_COLUMN_MAX inside, between on an edge's one-column ramp
    black = torch.zeros_like(frames)
    ramp = np.zeros(d.shape[:-1], bool)
    for meta in (jm, tm):
        add = t_step.render_frame(black, meta, run.tp, cfg)[..., 1].numpy()
        ramp |= (add > 0) & (add < EDGE_COLUMN_MAX)
    far = (np.abs(own.numpy().astype(int) - jo) > 1).any(-1)
    assert not (far & ~ramp).any(), \
        f"{int((far & ~ramp).sum())} pixels differ from JAX's off an edge"


@pytest.mark.parametrize("chunk", sorted(OVERLAY_AT_FIT_CONTRACT),
                         indirect=True)
def test_preset_render_matches_jax(chunk):
    """Where the overlays differ by more than 1, the renderer is exact:
    the difference is all in its inputs (demo2 and committed draw no lane
    on these frames)."""
    assert_render_matches(chunk[1])
