"""The second attempt's kernels and filter against the JAX package.

Inputs are the JAX package's own warped corridor channels of the stills
(the fixtures of tests/test_torch_filter_kernels.py).  Tolerance: exact
equality everywhere (the whole chain is integer), binaries and packed
prefixes alike.

* On the cropped 256x672 corridor patch (T=2) the plain twins of
  ``adaptive_mean``, ``merge_open`` and ``bilateral_threshold`` equal the
  Pallas kernels they replace, run in interpret mode as
  tests/test_filter_stage2.py runs them.
* At full corridor size (T=4), ``neighborhood_stage``, ``filter_stage`` on
  the ``ksize_b + 1 > 64`` route and ``second_attempt_artifacts_batch``
  equal the XLA chain ``filter_lane_points_channels(backend="xla")`` with
  ``build_row_prefixes``, and JAX's own second-attempt artifacts.

The CUDA kernels themselves are compared with the twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_filter_kernels import _t, channels, patch  # noqa: F401

from lane_tracker_tpu.kernels.filter_stage2 import (
    adaptive_mean_pallas2,
    bilateral_threshold_pallas2,
    merge_open_pallas2,
)
from lane_tracker_tpu.ops.filters import filter_lane_points_channels
from lane_tracker_tpu.ops.integrals import build_row_prefixes
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS, SECOND_ATTEMPT

from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.ops.filters import filter_stage, neighborhood_stage
from lane_tracker_tpu_torch.tracker import config as t_cfg
from lane_tracker_tpu_torch.tracker import step as t_step

F2 = SECOND_ATTEMPT.filter


def _xla_chain(f):
    """jit of the per-frame XLA filter chain for filter config ``f`` over
    a (T, H, W) batch: (binary, packed prefixes)."""

    @jax.jit
    def run(r, b):
        binary = jax.vmap(lambda r1, b1: filter_lane_points_channels(
            r1, b1, filter_type=f.filter_type, ksize_r=f.ksize_r, C_r=f.C_r,
            ksize_b=f.ksize_b, C_b=f.C_b, mask_noise=f.mask_noise,
            ksize_noise=f.ksize_noise, C_noise=f.C_noise,
            noise_thresh=f.noise_thresh, backend="xla",
            tophat_r=f.tophat_r, tophat_b=f.tophat_b,
            open_k=f.open_k))(r, b)
        return binary, jax.vmap(build_row_prefixes)(binary).packed

    return run


@pytest.mark.parametrize("chan,ksize,C", [("r", 15, -5), ("b", 35, -5),
                                          ("r", 35, 8)])
def test_adaptive_mean_twin_equals_pallas(patch, chan, ksize, C):
    img = patch[0] if chan == "r" else patch[1]
    want = np.asarray(adaptive_mean_pallas2(img, ksize, C, interpret=True))
    got = fs.adaptive_mean_plain(_t(img), ksize, C).numpy()
    assert 0 < (want > 0).mean() < 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_keep", [True, False])
def test_merge_open_twin_equals_pallas(patch, with_keep):
    r, b = patch
    r_th = np.asarray(adaptive_mean_pallas2(r, 15, -5, interpret=True))
    b_th = np.asarray(adaptive_mean_pallas2(b, 35, -5, interpret=True))
    keep = np.asarray(bilateral_threshold_pallas2(
        b, 65, 10, noise_thresh=135, interpret=True)) if with_keep else None
    want_bin, want_pref = merge_open_pallas2(
        r_th, b_th, keep, emit_prefixes=True, interpret=True)
    got_bin, got_pref = fs.merge_open_plain(
        _t(r_th), _t(b_th), None if keep is None else _t(keep))
    assert np.asarray(want_bin).any()
    np.testing.assert_array_equal(got_bin.numpy(), np.asarray(want_bin))
    np.testing.assert_array_equal(got_pref.packed.numpy(),
                                  np.asarray(want_pref.packed))


@pytest.mark.parametrize("ksize,C,noise_thresh", [(65, 5, -1),
                                                  (65, 10, 135)])
def test_bilateral_threshold_twin_equals_pallas(patch, ksize, C,
                                                noise_thresh):
    _, b = patch
    want = np.asarray(bilateral_threshold_pallas2(
        b, ksize, C, noise_thresh=noise_thresh, interpret=True))
    got = fs.bilateral_threshold_plain(_t(b), ksize, C, noise_thresh).numpy()
    assert 0 < (want > 0).mean() < 1
    np.testing.assert_array_equal(got, want)


def test_neighborhood_stage_equals_xla_chain_full_corridor(channels):
    r, b = channels
    want_bin, want_pref = (np.asarray(x) for x in _xla_chain(F2)(r, b))
    got_bin, got_pref = neighborhood_stage(_t(r), _t(b), F2.ksize_r, F2.C_r,
                                           F2.ksize_b, F2.C_b, F2.open_k)
    assert want_bin.shape == (4, 1100, 672) and want_bin.any()
    np.testing.assert_array_equal(got_bin.numpy(), want_bin)
    np.testing.assert_array_equal(got_pref.packed.numpy(), want_pref)


@pytest.mark.parametrize("mask_noise", [True, False])
def test_filter_stage_ksize_b65_equals_xla_chain_full_corridor(channels,
                                                               mask_noise):
    """The bilateral filter's route for ksize_b + 1 > 64: the standalone
    threshold, then merge + open (filter_stage2.py:1144-1154)."""
    r, b = channels
    jf = dataclasses.replace(PRESETS["demo1"].filter, ksize_b=65,
                             mask_noise=mask_noise)
    tf = t_cfg.FilterConfig(**dataclasses.asdict(jf))
    want_bin, want_pref = (np.asarray(x) for x in _xla_chain(jf)(r, b))
    got_bin, got_pref = filter_stage(_t(r), _t(b), tf)
    assert want_bin.any()
    np.testing.assert_array_equal(got_bin.numpy(), want_bin)
    np.testing.assert_array_equal(got_pref.packed.numpy(), want_pref)


def test_second_attempt_artifacts_equal_jax_full_corridor(channels):
    """Embedded attempt-2 prefixes and blind intervals of the four stills
    equal JAX's ``second_attempt_artifacts_batch`` (XLA filter chain)."""
    from tests.conftest import ASSETS_DIR
    from lane_tracker_tpu.calib.io import load_calibration_npz

    r, b = channels
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    jp = j_step.TrackerParams.build(*args, pipeline="corridor",
                                    filter_backend="xla")
    tp = t_step.TrackerParams.build(*args, pipeline="corridor",
                                    device="cpu")
    want_pref, want_iv = jax.jit(
        lambda r, b, p: j_step.second_attempt_artifacts_batch(r, b, p))(
            r, b, jp)
    got_pref, got_iv = t_step.second_attempt_artifacts_batch(_t(r), _t(b), tp)
    np.testing.assert_array_equal(got_pref.packed.numpy(),
                                  np.asarray(want_pref.packed))
    assert got_iv._fields == want_iv._fields
    for name, g, w in zip(got_iv._fields, got_iv, want_iv):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_new_wrappers_run_twins_on_cpu_without_counting(patch):
    r, b = patch
    fs.reset_launches()
    x, y = _t(r), _t(b)
    same = dict(rtol=0, atol=0)
    torch.testing.assert_close(fs.adaptive_mean(x, 15, -5),
                               fs.adaptive_mean_plain(x, 15, -5), **same)
    for got, want in zip(fs.merge_open(x, y), fs.merge_open_plain(x, y)):
        torch.testing.assert_close(got, want, **same)
    torch.testing.assert_close(fs.bilateral_threshold(y, 65, 5),
                               fs.bilateral_threshold_plain(y, 65, 5), **same)
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES}


@pytest.mark.parametrize("ksize", [14, 0])
def test_adaptive_mean_rejects_bad_ksize(ksize, monkeypatch):
    """Even and zero k are refused on the CPU and, before any launch, on
    the card."""
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="odd ksize"):
        fs.adaptive_mean(x, ksize, 5)
    monkeypatch.setattr(fs, "_on_cuda", lambda *imgs: True)
    monkeypatch.setattr(fs, "load_library", _no_library)
    with pytest.raises(ValueError, match="odd ksize"):
        fs.adaptive_mean(x, ksize, 5)


def _no_library():
    raise AssertionError("a kernel library was loaded for a refused k")


def test_adaptive_mean_above_kernel_limit_on_cpu_equals_pallas(patch,
                                                               monkeypatch):
    """Past the card kernel's limit the CPU twin still answers, equal to
    adaptive_mean_pallas2 (which takes any odd k) in interpret mode; the
    card's branch refuses that k before any launch."""
    k = fs.ADAPTIVE_MEAN_MAX_K + 2
    r, _ = patch
    small = np.ascontiguousarray(r[:1, :24, :40])
    want = np.asarray(adaptive_mean_pallas2(small, k, 5, interpret=True))
    got = fs.adaptive_mean(_t(small), k, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want > 0).mean() < 1
    monkeypatch.setattr(fs, "_on_cuda", lambda *imgs: True)
    monkeypatch.setattr(fs, "load_library", _no_library)
    fs.reset_launches()
    with pytest.raises(ValueError, match="ksize"):
        fs.adaptive_mean(_t(small), k, 5)
    assert fs.LAUNCHES["adaptive_mean"] == 0
