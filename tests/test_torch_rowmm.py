"""The latency mode's resampler (``kernels/resample_rowmm.py``) against the
JAX package's and against the port's own gather, on the CPU.

``LaneTracker(latency_mode=True)`` swaps the per-pixel gathers of the
two-stage warp for slab reads and one-hot contractions
(lane_tracker_tpu/kernels/resample_rowmm.py), bit for bit the gather.
Held at full size (assets/calibration.npz), every comparison exact:

* ``build_rowmm``'s iy0, starts, one-hot tensor, sizes and meta equal
  JAX's for 'fast''s two ROI grids, the corridor's cropped warp grid and
  'half''s grids (its warp grid has no tile structure: None in both);
* the three rowmm gathers equal JAX's rowmm gathers and the port's
  ``bilinear_gather`` / ``bilinear_gather_pair``, 'turbo''s fill bias
  included, on random sources;
* ``params_from_jax`` of JAX's ``with_rowmm()`` params equals the port's
  ``with_rowmm()``; 'compat' returns itself;
* ``warp_channels`` through the tile structures equals the gather's in
  'fast', 'corridor', 'turbo' and 'half';
* ``LaneTracker(latency_mode=True)`` equals ``latency_mode=False`` in
  every output of ``process`` and ``process_chunk``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_modes as tm
from tests.test_torch_tracker import DEMO1_KW, host_output, make_tracker

from lane_tracker_tpu.kernels import resample_rowmm as j_rowmm
from lane_tracker_tpu.tracker import step as j_step

from lane_tracker_tpu_torch.kernels import resample as t_resample
from lane_tracker_tpu_torch.kernels import resample_rowmm as t_rowmm
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.tracker import LaneTracker as TTracker


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def port_params(pipeline):
    if pipeline not in _PARAMS:
        _PARAMS[pipeline] = t_step.TrackerParams.build(
            *tm.calib_args(), pipeline=pipeline, device="cpu")
    return _PARAMS[pipeline]


def _jax_grid(pipeline, name):
    return getattr(j_step.TrackerParams.build(*tm.calib_args(),
                                              pipeline=pipeline), name)


@pytest.mark.parametrize("pipeline,name", [
    ("fast", "grid_und_roi"), ("fast", "grid_warp_roi"),
    ("corridor", "grid_warp_roi"), ("half", "grid_und_roi"),
    ("half", "grid_warp_roi")])
def test_build_rowmm_equals_jax(pipeline, name):
    jm = j_rowmm.build_rowmm(_jax_grid(pipeline, name))
    tm_ = t_rowmm.build_rowmm(getattr(port_params(pipeline), name))
    assert (jm is None) == (tm_ is None) == (name == "grid_warp_roi"
                                             and pipeline == "half")
    if jm is None:
        return
    assert (tm_.src_size, tm_.dst_size, tm_.meta) == (jm.src_size,
                                                      jm.dst_size, jm.meta)
    np.testing.assert_array_equal(tm_.iy0.numpy(), np.asarray(jm.iy0))
    np.testing.assert_array_equal(tm_.starts.numpy(), np.asarray(jm.starts))
    assert tm_.onehot.dtype == torch.bfloat16
    assert tuple(tm_.onehot.shape) == tuple(jm.onehot.shape)
    np.testing.assert_array_equal(tm_.onehot.float().numpy(),
                                  np.asarray(jm.onehot, np.float32))


@pytest.mark.parametrize("name", ["grid_und_roi", "grid_warp_roi"])
def test_rowmm_gathers_equal_jax_and_gather(name):
    """On 'turbo''s grids (the warp grid with its fill bias): the pair,
    the single gather of a 3-channel batch and the stacked planes."""
    jp = j_step.TrackerParams.build(*tm.calib_args(), pipeline="turbo")
    tp = port_params("turbo")
    jg, tg = getattr(jp, name), getattr(tp, name)
    jm, tmm = j_rowmm.build_rowmm(jg), t_rowmm.build_rowmm(tg)
    bias = tp.warp_b_bias if name == "grid_warp_roi" else None
    jbias = None if bias is None else jp.warp_b_bias
    Ws, Hs = jg.src_size
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, 256, (Hs, Ws), dtype=np.uint8) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    ja, jb = jax.jit(lambda x, y, g, m, bb: j_rowmm.bilinear_gather_pair_rowmm(
        x, y, g, m, bias_b=bb))(a, b, jg, jm, jbias)
    ma, mb = t_rowmm.bilinear_gather_pair_rowmm(ta, tb, tg, tmm, bias_b=bias)
    ga, gb = t_resample.bilinear_gather_pair(ta, tb, tg, bias_b=bias)
    for got, want, gather in ((ma, ja, ga), (mb, jb, gb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, gather)

    img = rng.integers(0, 256, (2, Hs, Ws, 3), dtype=np.uint8)
    got = t_rowmm.bilinear_gather_rowmm(torch.from_numpy(img), tg, tmm)
    assert torch.equal(got, t_resample.bilinear_gather(torch.from_numpy(img),
                                                       tg))
    want = jax.jit(jax.vmap(lambda x, g, m: j_rowmm.bilinear_gather_rowmm(
        x, g, m), in_axes=(0, None, None)))(img, jg, jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    biases = None if bias is None else [None, bias.reshape(tg.dst_shape)]
    jbiases = None if jbias is None else [None, jbias]
    planes = t_rowmm.gather_planes_rowmm(torch.stack([ta, tb]), tg, tmm,
                                         biases=biases)
    jplanes = jax.jit(lambda x, g, m, bb: j_rowmm.gather_planes_rowmm(
        x, g, m, biases=bb))(jnp.stack([a, b]), jg, jm, jbiases)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jplanes))
    assert torch.equal(planes[0], ga) and torch.equal(planes[1], gb)


@pytest.mark.parametrize("pipeline", ["fast", "turbo"])
def test_params_from_jax_with_rowmm(pipeline):
    jp = j_step.TrackerParams.build(*tm.calib_args(),
                                    pipeline=pipeline).with_rowmm()
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    assert len(leaves) == (34 if pipeline == "turbo" else 33)
    fp = t_step.params_from_jax(leaves, jp.tree_flatten()[1], device="cpu")
    want = port_params(pipeline).with_rowmm()
    a, b = dict(fp.named_buffers()), dict(want.named_buffers())
    assert set(a) == set(b) and "mm_warp.onehot" in a
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert fp.mm_warp.meta == want.mm_warp.meta
    leaves[-1] = np.zeros_like(leaves[-1])
    with pytest.raises(ValueError, match="rowmm leaves differ"):
        t_step.params_from_jax(leaves, jp.tree_flatten()[1], device="cpu")


def test_with_rowmm_compat_returns_itself():
    p = port_params("compat")
    assert p.with_rowmm() is p


@pytest.mark.parametrize("pipeline", ["fast", "corridor", "turbo", "half"])
def test_warp_channels_rowmm_equal_gather(pipeline):
    p = port_params(pipeline)
    pm = p.with_rowmm()
    assert pm.mm_und is not None
    assert (pm.mm_warp is None) == (pipeline == "half")
    frames = torch.from_numpy(tm.stills()[:2])
    for got, want in zip(t_step.warp_channels(frames, pm),
                         t_step.warp_channels(frames, p)):
        assert torch.equal(got, want)


def test_latency_mode_tracker_equals_gather_tracker():
    fs = tm.stills()[[0, 1, 2]]
    trackers = [make_tracker(TTracker, "fast", device="cpu",
                             latency_mode=mode) for mode in (True, False)]
    assert trackers[0].params.mm_warp is not None
    assert trackers[1].params.mm_warp is None
    for f in fs:
        got, want = (np.asarray(t.process(f, **DEMO1_KW)) for t in trackers)
        np.testing.assert_array_equal(got, want)
        a, b = (host_output(t.last_output) for t in trackers)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    outs = [t.process_chunk(fs, **DEMO1_KW) for t in trackers]
    for name in outs[0]._fields:
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name))
