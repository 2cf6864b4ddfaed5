"""Prefixes, corridor embedding, searches and fits against the JAX package.

Inputs are the JAX package's attempt-1 binaries of the four stills
(corridor compute window, XLA filter chain).  Tolerances: exact equality
for every integer output (prefixes, moments, embedding, sliding-window and
band intervals with their read extents, sample counts, validity); the f32
fit within 0.01 px RMSE of the JAX curve over the warped height.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import ASSETS_DIR

from lane_tracker_tpu.calib.io import load_calibration_npz
from lane_tracker_tpu.ops import integrals as j_int
from lane_tracker_tpu.ops import polyfit as j_fit
from lane_tracker_tpu.ops import search as j_search
from lane_tracker_tpu.ops.filters import filter_lane_points_channels
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS, SECOND_ATTEMPT

from lane_tracker_tpu_torch.ops import integrals as t_int
from lane_tracker_tpu_torch.ops import polyfit as t_fit
from lane_tracker_tpu_torch.ops import search as t_search
from lane_tracker_tpu_torch.tracker import step as t_step

CFG = PRESETS["demo1"]
WARPED = (1080, 1100)


def _args():
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    return (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)


@pytest.fixture(scope="module")
def binaries():
    """(params pair, compute-window binaries (4, 1100, 672), embedded
    full-width binaries (4, 1100, 1080)) from the JAX package."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        stills = z["frames"]
    jp = j_step.TrackerParams.build(*_args(), pipeline="corridor",
                                    filter_backend="xla")
    tp = t_step.TrackerParams.build(*_args(), pipeline="corridor",
                                    device="cpu")
    f = CFG.filter

    @jax.jit
    def front(frames, p):
        r, b = j_step._warp_channels_batch(frames, p)
        win = jax.vmap(lambda r1, b1: filter_lane_points_channels(
            r1, b1, ksize_r=f.ksize_r, C_r=f.C_r, ksize_b=f.ksize_b,
            C_b=f.C_b, mask_noise=f.mask_noise, ksize_noise=f.ksize_noise,
            C_noise=f.C_noise, noise_thresh=f.noise_thresh,
            backend="xla"))(r, b)
        return win, j_step._embed_cols(win, p)

    win, full = (np.array(x) for x in front(stills, jp))
    return (jp, tp), win, full


def test_row_prefixes_and_embedding_bit_exact(binaries):
    (jp, tp), win, full = binaries
    j_win = jax.jit(jax.vmap(j_int.build_row_prefixes))(win)
    t_win = t_int.build_row_prefixes(torch.from_numpy(win))
    np.testing.assert_array_equal(t_win.packed.numpy(),
                                  np.asarray(j_win.packed))  # shift 10
    t_full = t_int.build_row_prefixes(torch.from_numpy(full))
    np.testing.assert_array_equal(
        t_full.packed.numpy(),
        np.asarray(jax.jit(jax.vmap(j_int.build_row_prefixes))(full).packed))
    # Embedding: columns and repacked prefixes (shift 10 -> 11).
    np.testing.assert_array_equal(
        t_step._embed_cols(torch.from_numpy(win), tp).numpy(), full)
    j_emb = jax.jit(lambda p: j_step._embed_prefixes(p, jp))(j_win)
    t_emb = t_step._embed_prefixes(t_win, tp)
    np.testing.assert_array_equal(t_emb.packed.numpy(),
                                  np.asarray(j_emb.packed))
    np.testing.assert_array_equal(t_emb.packed.numpy(), t_full.packed.numpy())


def test_interval_moments_bit_exact(binaries):
    _, _, full = binaries
    rng = np.random.default_rng(3)
    H, W = full.shape[1:]
    lo = rng.integers(-20, W + 20, (4, H)).astype(np.int32)
    hi = (lo + rng.integers(-5, 200, (4, H))).astype(np.int32)
    valid = rng.random((4, H)) < 0.9
    t_pref = t_int.build_row_prefixes(torch.from_numpy(full))
    for t in range(4):
        j_pref = j_int.build_row_prefixes(full[t])
        want = jax.jit(j_int.interval_moments)(j_pref, lo[t], hi[t], valid[t])
        got = t_int.interval_moments(
            t_int.RowPrefixes(t_pref.packed[t]), torch.from_numpy(lo[t]),
            torch.from_numpy(hi[t]), torch.from_numpy(valid[t]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("which", ["demo1", "second_attempt", "random"])
def test_sliding_window_intervals_bit_exact(binaries, which):
    _, _, full = binaries
    scfg = (SECOND_ATTEMPT if which == "second_attempt" else CFG).search
    if which == "random":
        # Sparse noise exercises misses, drift, aborts and the slice quirks.
        rng = np.random.default_rng(7)
        full = np.where(rng.random(full.shape) < 0.002, 255, 0).astype(
            np.uint8)
    H, W = full.shape[1:]

    @jax.jit
    def jax_iv(b):
        return jax.vmap(lambda x: j_search.sliding_window_intervals(
            j_search.sws_precompute(x, scfg), scfg, H, W))(b)

    want = jax_iv(full)
    got = t_search.sliding_window_intervals(
        t_search.sws_precompute(torch.from_numpy(full), scfg), scfg, H, W)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_band_intervals_bit_exact():
    oracle = np.load(ASSETS_DIR / "bench_oracle.npz")
    H, W = WARPED[1], WARPED[0]
    for t in range(8):
        lc = oracle["left"][t].astype(np.float32)
        rc = oracle["right"][t].astype(np.float32)
        want = jax.jit(lambda a, b: j_search.band_intervals(
            a, b, CFG.search, H, W))(lc, rc)
        got = t_search.band_intervals(torch.from_numpy(lc),
                                      torch.from_numpy(rc), CFG.search, H, W)
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def test_fit_validity_radius_ecc(binaries):
    """Fits from the sliding-window moments of each still: curves within
    0.01 px RMSE; counts and validity exact; radius and eccentricity to
    f32 rounding of the same closed forms."""
    (jp, tp), _, full = binaries
    H, W = full.shape[1:]
    scfg = CFG.search
    t_pref = t_int.build_row_prefixes(torch.from_numpy(full))
    t_iv = t_search.sliding_window_intervals(
        t_search.sws_precompute(torch.from_numpy(full), scfg), scfg, H, W)
    ln, lsx = t_int.interval_moments(t_pref, t_iv.left_lo, t_iv.left_hi,
                                     t_iv.left_valid)
    rn, rsx = t_int.interval_moments(t_pref, t_iv.right_lo, t_iv.right_hi,
                                     t_iv.right_valid)
    n = torch.stack([ln, rn], 1)  # (4, 2, H)
    sx = torch.stack([lsx, rsx], 1)
    got = t_fit.fit_poly_rows(n, sx, W)
    want = np.array(jax.jit(lambda a, b: j_fit.fit_poly_rows(a, b, W))(
        n.numpy(), sx.numpy()))
    yy = np.arange(H, dtype=np.float64)
    for g, w in zip(got.reshape(-1, 3).numpy(), want.reshape(-1, 3)):
        rmse = np.sqrt(np.mean((np.polyval(g.astype(float), yy)
                                - np.polyval(w.astype(float), yy)) ** 2))
        assert rmse <= 0.01, rmse

    # Downstream of the fit, fed the same (JAX) coefficients.
    wc = torch.from_numpy(want)
    ploty = t_fit.ploty_grid(WARPED, 1.0)
    np.testing.assert_array_equal(ploty.numpy(),
                                  np.asarray(j_fit.ploty_grid(WARPED, 1.0)))
    tm = t_fit.poly_points_meta(wc, ploty, WARPED)
    jm = jax.jit(lambda c: j_fit.poly_points_meta(
        c, j_fit.ploty_grid(WARPED, 1.0), WARPED))(want)
    np.testing.assert_array_equal(tm.n.numpy(), np.asarray(jm.n))
    np.testing.assert_array_equal(tm.first.numpy(), np.asarray(jm.first))
    np.testing.assert_allclose(tm.fitx.numpy(), np.asarray(jm.fitx),
                               rtol=0, atol=1e-3)
    for t in range(4):
        lc, rc = want[t, 0], want[t, 1]
        nl, nr = int(jm.n[t, 0]), int(jm.n[t, 1])
        for vcfg in (CFG.validity, PRESETS["demo3"].validity):
            jv = bool(j_fit.check_validity(lc, rc, jnp.int32(nl),
                                           jnp.int32(nr), WARPED, vcfg))
            tv = bool(t_fit.check_validity(
                wc[t, 0], wc[t, 1], torch.tensor(nl, dtype=torch.int32),
                torch.tensor(nr, dtype=torch.int32), WARPED, vcfg))
            assert tv == jv
        for c in (lc, rc):
            jr = float(j_fit.curve_radius_m(c, WARPED, jp.mppv, jp.mpph))
            tr = float(t_fit.curve_radius_m(torch.from_numpy(c), WARPED,
                                            tp.mppv, tp.mpph))
            assert abs(tr - jr) <= max(1.0, 1e-5 * abs(jr))
        lb, rb = np.trunc(lc[2]), np.trunc(rc[2])
        je = float(j_fit.eccentricity_m(jnp.float32(lb), jnp.float32(rb),
                                        WARPED, jp.mpph))
        te = float(t_fit.eccentricity_m(torch.tensor(lb), torch.tensor(rb),
                                        WARPED, tp.mpph))
        assert te == je
