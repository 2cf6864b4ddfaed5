"""The row-sharded front half (``parallel/rows.py``) and ``stream_row_mesh``.

The port's counterpart of tests/test_parallel.py:163-188, where JAX's
front half runs on frames sharded over a 'rows' axis: here each band of
warped rows computes its rows plus a halo (the filter chain's vertical
reach) on its own device, and the bands are assembled on the first.

Held on the CPU, bands over repeated ``"cpu"`` devices:

* ``stream_row_mesh``'s shape and devices; its default needs CUDA;
* the sharded front half over 2 and 3 bands equal to
  ``front_artifacts_batch`` in every field, bit for bit: demo1 'corridor'
  and 'fast' on two stills and a black frame, ``hoist`` on and off, each
  pipeline over both band counts (and 'compat' without it);
* ``chunk_process(..., row_devices=...)`` equal to the unsharded call in
  every output and state field, in each second-attempt mode;
* the sharded 'fast' front half equal to JAX's ``front_artifacts`` on
  frames 911 and 971 (tests/test_parallel.py's frames);
* the reach is needed: on a crafted LAB-B (a 54-row bright plateau ending
  35 rows above a faint 5-row bar at the band's edge, one dark row beyond
  the plateau), a halo one row short of ``filter_reach`` changes the
  band's edge row, at the top and at the bottom; the computed halo gives
  the full frame's rows;
* along the columns, the same profile shows the corridor's 80-column
  compute margin (JAX's) below the reach: it changes a kept column.
"""

import numpy as np
import pytest
import torch

import jax

from tests.conftest import ASSETS_DIR
from tests.test_torch_pipeline import port_config
from tests.test_torch_pipeline_full import _calib_args

from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.parallel import pipeline as t_pipeline
from lane_tracker_tpu_torch.parallel.mesh import stream_row_mesh
from lane_tracker_tpu_torch.parallel.rows import (
    filter_reach,
    front_artifacts_rows,
    front_halo,
    row_bounds,
)
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.config import SECOND_ATTEMPT

CFG = PRESETS["demo1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Full-size frames through PyTorch's CPU operators: with the suite's
    workers sharing the cores, the intra-op thread pool makes each far
    dearer than the work (this file ran 26x slower under the suite than
    alone).  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(arts):
    """(name, tensor or None) of every field of a FrontArtifacts, the
    NamedTuples' fields in order."""
    out = []
    for name, x in zip(arts._fields, arts):
        if x is None or isinstance(x, (torch.Tensor, np.ndarray, jax.Array)):
            out.append((name, x))
        else:
            out += [(f"{name}.{n}", v) for n, v in zip(x._fields, x)]
    return out


def assert_arts_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        if b is None:
            assert a is None, name
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


_PARAMS = {}


def port_params(pipeline):
    if pipeline not in _PARAMS:
        _PARAMS[pipeline] = t_step.TrackerParams.build(
            *_calib_args(), pipeline=pipeline, device="cpu")
    return _PARAMS[pipeline]


@pytest.fixture(scope="module")
def frames():
    """Two stills and a black frame (the second attempt's input)."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        st = z["frames"]
    return torch.from_numpy(np.concatenate([st[:2], np.zeros_like(st[:1])]))


def test_stream_row_mesh_shape_and_devices():
    mesh = stream_row_mesh(2, 3, devices=["cpu"] * 7)
    assert len(mesh) == 2 and all(len(row) == 3 for row in mesh)
    assert all(d == torch.device("cpu") for row in mesh for d in row)
    assert stream_row_mesh(1, 2, devices=("cpu", "cpu")) == (
        (torch.device("cpu"), torch.device("cpu")),)
    with pytest.raises(ValueError, match="needs 4 devices"):
        stream_row_mesh(2, 2, devices=("cpu",) * 3)


def test_stream_row_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream_row_mesh(1, 2)


def test_reach_of_the_presets():
    """demo1's attempt 1: LAB-B's tophat 2 * 27 + cross arm 35 + open
    2 * 2; the second attempt: the k=35 box's 17 + 4."""
    assert filter_reach(CFG.filter) == 93
    assert filter_reach(SECOND_ATTEMPT.filter) == 21
    params = port_params("fast")
    assert front_halo(CFG, True, params) == front_halo(CFG, False,
                                                       params) == 93
    assert row_bounds(1100, 3) == [(0, 366), (366, 733), (733, 1100)]


@pytest.mark.parametrize("pipeline,hoist,n_bands", [
    ("corridor", False, 2), ("corridor", True, 3), ("fast", False, 3),
    ("fast", True, 2), ("compat", False, 3)])
def test_row_sharded_front_half_equals_batch(frames, pipeline, hoist,
                                             n_bands):
    params = port_params(pipeline)
    want = t_step.front_artifacts_batch(frames, params, CFG, hoist)
    got = front_artifacts_rows(frames, params, CFG, ("cpu",) * n_bands, hoist)
    assert (got.pref2 is not None) == hoist
    assert_arts_equal(got, want)


@pytest.mark.parametrize("pipeline,mode,n_bands", [
    ("corridor", "hoist", 3), ("corridor", "cond", 2),
    ("fast", "two_phase", 2)])
def test_chunk_process_with_row_devices_equals_unsharded(frames, pipeline,
                                                         mode, n_bands):
    params = port_params(pipeline)

    def run(**kw):
        return t_pipeline.chunk_process(
            t_step.make_initial_state(CFG, params.warped_size, "cpu"),
            frames, params, CFG, with_overlay=True, second_attempt=mode,
            **kw)

    st_a, out_a = run()
    st_b, out_b = run(row_devices=("cpu",) * n_bands)
    assert not bool(out_a.a1_valid[2])  # the black frame took attempt 2
    for name, a in out_a._asdict().items():
        assert torch.equal(a, getattr(out_b, name)), name
    for name, a in st_a._asdict().items():
        assert torch.equal(a, getattr(st_b, name)), name


def test_row_sharded_fast_equals_jax_front_artifacts():
    """tests/test_parallel.py's frames (911, 971), 'fast', demo1: JAX's
    per-frame ``front_artifacts`` (XLA) against the port's front half over
    two CPU bands."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        fr = z["frames"][:2]
    jp = j_step.TrackerParams.build(*_calib_args(), pipeline="fast",
                                    filter_backend="xla")
    want = jax.jit(lambda f, p: jax.vmap(
        lambda x: j_step.front_artifacts(x, p, CFG))(f))(fr, jp)
    got = front_artifacts_rows(torch.from_numpy(fr), port_params("fast"),
                               port_config(CFG), ("cpu", "cpu"))
    assert_arts_equal(got, want)


def crafted_channels(H=300, W=256, a=150):
    """(R, LAB-B) of one frame whose binary row ``a`` depends on LAB-B row
    a - 93 and on nothing farther: a dark row a - 93, a 200 plateau on
    rows a-92 .. a-39 (54 rows: the k=55 opening removes it, so its bottom
    row's tophat enters row a-4's up arm), then 8 on row a-4 (it passes
    the cross threshold only while that arm holds no plateau) and 10 on
    rows a-3 .. a (they pass; with row a-4 the 5 x 5 open keeps the five
    rows, without it none).  R is black, LAB-B below 140 keeps the noise
    mask open."""
    b = torch.zeros(1, H, W, dtype=torch.uint8)
    b[0, a - 92:a - 38] = 200
    b[0, a - 4] = 8
    b[0, a - 3:a + 1] = 10
    return torch.zeros_like(b), b


def band_rows(r_ext, b_ext, f, lo, hi):
    """Rows [lo, hi) of the filter's binary and packed row prefixes of a
    band's extended channels, as ``front_artifacts_rows`` keeps them."""
    binary, pref = filter_stage(r_ext, b_ext, f)
    return binary[:, lo:hi], pref.packed[:, lo:hi]


@pytest.mark.parametrize("edge", ["top", "bottom"])
def test_halo_one_row_short_changes_the_band_edge(edge):
    f = CFG.filter
    reach = filter_reach(f)
    H, a = 300, 150
    r, b = crafted_channels(H, a=a)
    if edge == "bottom":  # the same profile upside down
        r, b = r.flip(1), b.flip(1)
    full, full_pref = filter_stage(r, b, f)
    for halo in (reach, reach - 1):
        if edge == "top":  # the band [a, H), its halo above
            e0 = a - halo
            got, pref = band_rows(r[:, e0:], b[:, e0:], f, a - e0, H - e0)
            want, want_pref, edge_row = full[:, a:], full_pref.packed[:, a:], 0
        else:  # the band [0, H - a), its halo below
            e1 = H - a + halo
            got, pref = band_rows(r[:, :e1], b[:, :e1], f, 0, H - a)
            want = full[:, :H - a]
            want_pref, edge_row = full_pref.packed[:, :H - a], H - a - 1
        differ = sorted({int(y) for y in (got != want).nonzero()[:, 1]})
        if halo == reach:
            assert differ == []
            assert torch.equal(pref, want_pref)
        else:
            assert differ == [edge_row], differ


def test_corridor_margin_is_below_the_filter_reach():
    """The reach holds along the columns too.  'corridor' computes the
    warped columns [x0 - 80, x1 + 80) (``CORRIDOR_MARGIN``, the JAX
    package's margin, sized by a reach of 75) and keeps [x0, x1): the
    crafted profile laid along the columns changes the first kept column,
    which a margin of ``filter_reach`` (93) keeps exact.  The port equals
    JAX's corridor, margin included (ROADMAP queue 3)."""
    f = CFG.filter
    r, b = (x.transpose(1, 2).contiguous() for x in crafted_channels())
    x0 = 150
    full, _ = filter_stage(r, b, f)
    for margin, differ in ((t_step.CORRIDOR_MARGIN, [0]),
                           (filter_reach(f), [])):
        c0 = x0 - margin
        win, _ = filter_stage(r[..., c0:].contiguous(),
                              b[..., c0:].contiguous(), f)
        d = (win[..., margin:] != full[..., x0:]).nonzero()[:, 2]
        assert sorted(set(d.tolist())) == differ, margin
