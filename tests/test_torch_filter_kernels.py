"""The three filter-stage kernels' plain twins against the JAX package.

Inputs are the JAX package's own warped corridor channels of the stills,
so every comparison here is of the filter alone.  Tolerance: exact
equality (the whole chain is integer), binaries and packed prefixes alike.

* On a cropped corridor patch (rows 700..955, all 672 columns, T=2) each
  twin equals its Pallas kernel run in interpret mode, as
  tests/test_filter_stage2.py runs them.
* At full corridor size (T=4) the composed filter equals the XLA chain
  ``filter_lane_points_channels(backend="xla")``, with and without the
  noise mask, and its prefixes equal ``build_row_prefixes`` of that binary.

The CUDA kernels themselves are compared with the twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax

from tests.conftest import ASSETS_DIR
from tests.torch_filter_models import tophat_model, tophat_tiles

from lane_tracker_tpu.calib.io import load_calibration_npz
from lane_tracker_tpu.kernels.filter_stage2 import (
    thr_merge_open_pallas2,
    tophat_pallas2,
    tophat_riders_pallas2,
)
from lane_tracker_tpu.ops.filters import filter_lane_points_channels
from lane_tracker_tpu.ops.integrals import build_row_prefixes
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.tracker.config import FilterConfig

F = PRESETS["demo1"].filter


@pytest.fixture(scope="module")
def channels():
    """JAX's warped corridor (R, LAB-B) of the four stills, (4, 1100, 672)."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        stills = z["frames"]
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    jp = j_step.TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor")
    r, b = jax.jit(lambda f, p: j_step._warp_channels_batch(f, p))(stills, jp)
    return np.asarray(r), np.asarray(b)


@pytest.fixture(scope="module")
def patch(channels):
    """test4 and frame911, rows 700..955 of the corridor window."""
    r, b = channels
    return (np.ascontiguousarray(r[[2, 0], 700:956]),
            np.ascontiguousarray(b[[2, 0], 700:956]))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("chan,ksize", [("r", 29), ("b", 55)])
def test_tophat_twin_equals_pallas(patch, chan, ksize):
    img = patch[0] if chan == "r" else patch[1]
    want = np.asarray(tophat_pallas2(img, ksize, interpret=True))
    got = fs.tophat_ellipse_plain(_t(img), ksize).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chan,ksize", [("r", 29), ("b", 55)])
def test_tophat_kernel_model_equals_pallas(patch, chan, ksize):
    """The redesigned kernel's numpy model (tests/torch_filter_models.py),
    at the tiles its planner picks for the full corridor frame."""
    img = patch[0] if chan == "r" else patch[1]
    want = np.asarray(tophat_pallas2(img, ksize, interpret=True))
    tw, th = tophat_tiles(ksize, 1100, 672)
    got = tophat_model(img, ksize, tw, th, np.random.default_rng(ksize))
    np.testing.assert_array_equal(got, want)


def test_tophat_riders_twin_equals_pallas(patch):
    r, b = patch
    r_feat = np.asarray(tophat_pallas2(r, F.tophat_r, interpret=True))
    riders = [(r_feat, F.ksize_r, F.C_r, -1),
              (b, F.ksize_noise, F.C_noise, F.noise_thresh)]
    want = tophat_riders_pallas2(b, F.tophat_b, riders, interpret=True)
    got = fs.tophat_riders_plain(
        _t(b), F.tophat_b, [(_t(s), k, C, nt) for s, k, C, nt in riders])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_keep", [True, False])
def test_thr_merge_open_twin_equals_pallas(patch, with_keep):
    r, b = patch
    r_feat = np.asarray(tophat_pallas2(r, F.tophat_r, interpret=True))
    riders = [(r_feat, F.ksize_r, F.C_r, -1),
              (b, F.ksize_noise, F.C_noise, F.noise_thresh)]
    b_feat, r_th, keep = (np.asarray(x) for x in tophat_riders_pallas2(
        b, F.tophat_b, riders, interpret=True))
    keep = keep if with_keep else None
    want_bin, want_pref = thr_merge_open_pallas2(
        r_th, b_feat, F.ksize_b, F.C_b, keep, emit_prefixes=True,
        interpret=True)
    got_bin, got_pref = fs.thr_merge_open_plain(
        _t(r_th), _t(b_feat), F.ksize_b, F.C_b,
        None if keep is None else _t(keep))
    assert np.asarray(want_bin).any()
    np.testing.assert_array_equal(got_bin.numpy(), np.asarray(want_bin))
    np.testing.assert_array_equal(got_pref.packed.numpy(),
                                  np.asarray(want_pref.packed))


@pytest.mark.parametrize("mask_noise", [True, False])
def test_filter_stage_equals_xla_chain_full_corridor(channels, mask_noise):
    r, b = channels
    f = F if mask_noise else PRESETS["demo2"].filter
    assert f.mask_noise == mask_noise

    @jax.jit
    def xla(r, b):
        binary = jax.vmap(lambda r1, b1: filter_lane_points_channels(
            r1, b1, filter_type=f.filter_type, ksize_r=f.ksize_r, C_r=f.C_r,
            ksize_b=f.ksize_b, C_b=f.C_b, mask_noise=f.mask_noise,
            ksize_noise=f.ksize_noise, C_noise=f.C_noise,
            noise_thresh=f.noise_thresh, backend="xla"))(r, b)
        return binary, jax.vmap(build_row_prefixes)(binary).packed

    want_bin, want_pref = (np.asarray(x) for x in xla(r, b))
    got_bin, got_pref = filter_stage(_t(r), _t(b), f)
    assert want_bin.shape == (4, 1100, 672) and want_bin.any()
    np.testing.assert_array_equal(got_bin.numpy(), want_bin)
    np.testing.assert_array_equal(got_pref.packed.numpy(), want_pref)


def test_wrappers_run_twins_on_cpu_without_counting(patch):
    r, _ = patch
    fs.reset_launches()
    x = _t(r)
    torch.testing.assert_close(fs.tophat_ellipse(x, 29),
                               fs.tophat_ellipse_plain(x, 29), rtol=0, atol=0)
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES}


@pytest.mark.parametrize("bad", ["dtype", "rank", "shape", "device"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.zeros((2, 40, 48), dtype=torch.uint8)
    y = x.clone()
    if bad == "dtype":
        x = x.int()
    elif bad == "rank":
        x = x[0]
    elif bad == "shape":
        y = y[:, :20]
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        if bad in ("shape", "device"):
            fs.thr_merge_open(x, y, 35, 5)
        else:
            fs.tophat_ellipse(x, 29)


def test_unported_filter_raises():
    """A filter type the reference does not have raises.  'neighborhood'
    with mask_noise, which raised here until it was ported, runs: on the
    CPU its plain chain (two adaptive means, the noise keep-mask, merge +
    open); tests/test_torch_neighborhood.py holds it to JAX."""
    x = torch.randint(0, 120, (1, 160, 200), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    # Flat and above noise_thresh: masked out inside its border.
    x[:, 20:140, 20:180] = 200
    with pytest.raises(ValueError, match="filter_type"):
        filter_stage(x, x, FilterConfig(filter_type="median"))
    f = FilterConfig(filter_type="neighborhood", mask_noise=True,
                     noise_thresh=128)
    keep = fs.bilateral_threshold_plain(x, f.ksize_noise, f.C_noise,
                                        f.noise_thresh)
    want = fs.merge_open_plain(fs.adaptive_mean_plain(x, f.ksize_r, -f.C_r),
                               fs.adaptive_mean_plain(x, f.ksize_b, -f.C_b),
                               keep, f.open_k)
    got = filter_stage(x, x, f)
    assert 0 < (keep > 0).float().mean() < 1
    for g, w in zip((got[0], got[1].packed), (want[0], want[1].packed)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
