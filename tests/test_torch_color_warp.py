"""Warp and LAB-B of the port against the JAX package.

Tolerances: exact equality for the cube-root table, for rgb2lab_b_fast
over a sampled RGB grid and over every warped pixel of the four stills,
for the fixed-point undistort, and for the float warp of all three RGB
channels and the tracker's warped R.  The tracker's LAB-B is held to the
reference's warp contract (<= 1 unit on < 0.05% of pixels): JAX's tracker
program contracts the G channel's tap sum in another order than its own
``bilinear_gather`` does (1 value of LAB-B moves in 'corridor', 1 in
'fast').
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import ASSETS_DIR

from lane_tracker_tpu.calib.io import load_calibration_npz
from lane_tracker_tpu.kernels.resample import bilinear_gather
from lane_tracker_tpu.ops import color as j_color
from lane_tracker_tpu.tracker import step as j_step

from lane_tracker_tpu_torch.kernels.resample import (
    bilinear_gather as bilinear_gather_t,
)
from lane_tracker_tpu_torch.ops import color as t_color
from lane_tracker_tpu_torch.tracker import step as t_step


def test_gamma_and_tables_copies():
    for a, b in zip(j_color._tables(), t_color._tables()):
        np.testing.assert_array_equal(a, b)
    assert t_color._GAMMA_POLY_COEFS == j_color._GAMMA_POLY_COEFS
    assert t_color._GAMMA_POLY_MID == j_color._GAMMA_POLY_MID
    assert t_color._GAMMA_POLY_HALF == j_color._GAMMA_POLY_HALF
    # The port's f32 polynomial reproduces the reference's on all 256 inputs.
    x = np.arange(256, dtype=np.float32)
    want = np.asarray(jax.jit(j_color._gamma_poly_f32)(x))
    got = t_color._gamma_poly_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cbrt_table_equals_reference_expression():
    """rint(2^15 * f(t)) of the reference's f32 expression (color.py:
    255-261) at every reachable t = idx/2040 equals ``cbrt_tab``."""
    idx = jnp.arange(3072, dtype=jnp.float32)

    @jax.jit
    def f(idx):
        t = idx * jnp.float32(1.0 / (255.0 * 8))
        cbrt = jnp.where(t < jnp.float32(0.008856),
                         t * jnp.float32(7.787)
                         + jnp.float32(0.13793103448275862), jnp.cbrt(t))
        return jnp.rint(jnp.float32(1 << 15) * cbrt)

    want = np.asarray(f(idx)).astype(np.int64)
    got = t_color._cbrt_table(torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def test_rgb2lab_b_fast_sampled_grid():
    """Every 3rd value per channel: 86^3 colors, bit-exact."""
    v = np.arange(0, 256, 3, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    want = np.asarray(jax.jit(j_color.rgb2lab_b_fast)(rgb))
    got = t_color.rgb2lab_b_fast(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def stills():
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        return z["frames"]


def _params(pipeline):
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    return (j_step.TrackerParams.build(*args, pipeline=pipeline),
            t_step.TrackerParams.build(*args, pipeline=pipeline,
                                       device="cpu"))


def _jax_warped_rgb(stills, jp):
    """The reference's two-stage resample of all three channels."""
    ry0, ry1 = jp.raw_roi

    @jax.jit
    def f(fr):
        und = bilinear_gather(fr[ry0:ry1], jp.grid_und_roi)
        return bilinear_gather(und, jp.grid_warp_roi)

    return np.stack([np.asarray(f(fr)) for fr in stills])


def test_lab_b_on_warped_stills_bit_exact(stills):
    """LAB-B over every warped pixel of the four stills (corridor window),
    from the same RGB, bit-exact."""
    jp, _ = _params("corridor")
    rgb = _jax_warped_rgb(stills, jp)
    want = np.asarray(jax.jit(j_color.rgb2lab_b_fast)(rgb))
    got = t_color.rgb2lab_b_fast(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_undistort_stage_bit_exact(stills):
    """The fixed-point undistort (integer combine) is bit-exact."""
    jp, tp = _params("corridor")
    ry0, ry1 = jp.raw_roi
    want = np.stack([np.asarray(jax.jit(
        lambda fr: bilinear_gather(fr[ry0:ry1], jp.grid_und_roi))(fr))
        for fr in stills])
    got = bilinear_gather_t(torch.from_numpy(stills[:, ry0:ry1]),
                            tp.grid_und_roi).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pipeline", ["corridor", "fast"])
def test_warp_rgb_stills_bit_exact(stills, pipeline):
    """The two-stage resample of all three RGB channels equals JAX's
    ``bilinear_gather`` chain bit for bit: the port evaluates the float
    combine as the fused multiply-add chain XLA contracts it into."""
    jp, tp = _params(pipeline)
    want = _jax_warped_rgb(stills, jp)
    ry0, ry1 = tp.raw_roi
    und = bilinear_gather_t(torch.from_numpy(stills[:, ry0:ry1]),
                            tp.grid_und_roi)
    got = bilinear_gather_t(und, tp.grid_warp_roi).numpy()
    assert got.shape == want.shape
    for c, name in enumerate("RGB"):
        n_diff = int((got[..., c] != want[..., c]).sum())
        print(f"{pipeline} {name}: {n_diff} of {want[..., c].size} differ")
        assert n_diff == 0, name


@pytest.mark.parametrize("pipeline", ["corridor", "fast"])
def test_warp_channels_stills(stills, pipeline):
    """Warped R and LAB-B of the four stills against the tracker's own
    ``_warp_channels_batch``: R bit-exact; LAB-B held to the reference's
    warp contract, at most 1 unit on fewer than 0.05% of pixels.

    XLA contracts the G channel's tap sum (the second output of the
    tracker's pair gather) in another order than the R and B channels'
    (fma(p11, w11, fma(p10, w10, fma(p01, w01, p00 * w00)))), which moves
    a rint on 1 G value per window, and through it 1 LAB-B value; the
    port's LAB-B equals JAX's rgb2lab_b_fast of JAX's bilinear_gather RGB
    (test above, and test_lab_b_on_warped_stills_bit_exact)."""
    jp, tp = _params(pipeline)
    jr, jb = jax.jit(lambda f, p: j_step._warp_channels_batch(f, p))(stills, jp)
    tr, tb = t_step.warp_channels(torch.from_numpy(stills), tp)
    width = 672 if pipeline == "corridor" else 1080
    assert tuple(tr.shape) == tuple(tb.shape) == (4, 1100, width)
    for name, want, got in (("R", jr, tr), ("LAB-B", jb, tb)):
        d = np.abs(np.asarray(want).astype(int) - got.numpy().astype(int))
        n_diff = int((d != 0).sum())
        print(f"{pipeline} {name}: {n_diff} of {d.size} differ, max {d.max()}")
        assert d.max() <= 1, name
        assert n_diff < 0.0005 * d.size, (name, n_diff)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
