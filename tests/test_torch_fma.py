"""The float warp combine's multiply-add against exact arithmetic and JAX.

``resample.fma_f32(p, w, c)`` must be the correctly rounded f32 of the exact
``p*w + c`` (one rounding, as a true fma).  The reference here is exact:
``fractions.Fraction`` arithmetic, rounded to f32 by hand (nearest, ties
to even).  The adversarial triples are built so that rounding the sum to
float64 first lands exactly on an f32 tie the exact sum is not on:
``233 * (2304167 * 2^-51) = 2^-22 - 2^-51`` (2^29 - 1 = 233 * 1103 * 2089),
so ``c + p*w`` sits 2^-51 below the midpoint after ``c`` in [4, 8), and
float64 (ulp 2^-50 there) rounds that tie to the midpoint.

``combine_taps`` is then held to JAX's ``bilinear_gather`` at every pixel
of the corridor and 'fast' warp grids with a weight below 2^-20, on tap
values from a random sweep and from an adversarial search (the taps whose
f32 sum lies nearest a rint tie).  Tolerance: 0 values differ.
"""

import fractions

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import ASSETS_DIR

from lane_tracker_tpu.calib.io import load_calibration_npz
from lane_tracker_tpu.kernels import resample as j_resample
from lane_tracker_tpu.tracker import step as j_step

from lane_tracker_tpu_torch.kernels import resample as t_resample
from lane_tracker_tpu_torch.tracker import step as t_step

TINY = 2.0 ** -20
ADV_W = 2304167 * 2.0 ** -51  # an f32: 2304167 < 2^24


def f32_round(x: fractions.Fraction) -> float:
    """Nearest f32 of an exact rational (ties to even); normal range."""
    if x == 0:
        return 0.0
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while fractions.Fraction(2) ** e > x:
        e -= 1
    while fractions.Fraction(2) ** (e + 1) <= x:
        e += 1
    scale = fractions.Fraction(2) ** (e - 23)  # the f32 ulp at x
    m = x / scale
    q, rem = divmod(m.numerator, m.denominator)
    twice = 2 * rem
    if twice > m.denominator or (twice == m.denominator and q % 2 == 1):
        q += 1
    return float(sign * q * scale)


def exact_fma(p, w, c):
    return np.array([
        f32_round(fractions.Fraction(int(pi)) * fractions.Fraction(float(wi))
                  + fractions.Fraction(float(ci)))
        for pi, wi, ci in zip(p, w, c)], dtype=np.float32)


def port_fma(p, w, c):
    return t_resample.fma_f32(torch.from_numpy(np.asarray(p, np.uint8)),
                           torch.from_numpy(np.asarray(w, np.float64)),
                           torch.from_numpy(np.asarray(c, np.float32))).numpy()


def adversarial_triples():
    """(p, w, c) where float64-then-f32 rounding is off by one f32 place:
    c in [4, 8) * 2^j with an odd f32 mantissa, p*w = (2^-22 - 2^-51) * 2^j."""
    p, w, c = [], [], []
    for j in range(-2, 6):
        for m in range(1, 40, 2):  # odd mantissas
            p.append(233)
            w.append(ADV_W * 2.0 ** j)
            c.append((4.0 + m * 2.0 ** -21) * 2.0 ** j)
    return (np.array(p, np.uint8), np.array(w, np.float64),
            np.array(c, np.float32))


def test_adversarial_triples_need_one_rounding():
    """The triples really break float64-then-f32 rounding, and the port's
    fma_f32 rounds them once."""
    p, w, c = adversarial_triples()
    assert np.all(np.float32(w) == w)  # the weights are f32 values
    want = exact_fma(p, w, c)
    double_rounded = (p.astype(np.float64) * w + c.astype(np.float64)
                      ).astype(np.float32)
    assert np.all(double_rounded != want)
    np.testing.assert_array_equal(port_fma(p, w, c), want)


@pytest.mark.parametrize("seed", range(4))
def test_fma_random_triples_equal_exact(seed):
    """Random taps, f32 weights over the grids' whole range (down to 2^-30)
    and f32 partial sums up to 255 (a quarter of them negative)."""
    rng = np.random.default_rng(seed)
    n = 4000
    p = rng.integers(0, 256, n).astype(np.uint8)
    w = (rng.uniform(0.5, 1.0, n) * 2.0 ** -rng.integers(0, 31, n))
    w = w.astype(np.float32).astype(np.float64)
    c = (rng.uniform(0, 255, n) * np.where(rng.random(n) < 0.25, -1, 1))
    c = c.astype(np.float32)
    np.testing.assert_array_equal(port_fma(p, w, c), exact_fma(p, w, c))


def test_fma_tiny_weight_near_ties_equal_exact():
    """Taps and sums chosen so the exact sum lies within a few float64
    places of an f32 tie: the double rounding's failure region."""
    rng = np.random.default_rng(7)
    n = 4000
    p = rng.integers(1, 256, n).astype(np.uint8)
    e = rng.integers(-2, 6, n)
    c = ((4.0 + rng.integers(0, 2 ** 21, n) * 2.0 ** -21) * 2.0 ** e)
    c = c.astype(np.float32)
    # w ~ (2^-22 * 2^e + d) / p, rounded to f32, d a few float64 places.
    d = rng.integers(-8, 9, n) * 2.0 ** -51
    w = ((2.0 ** -22 + d) * 2.0 ** e / p).astype(np.float32).astype(
        np.float64)
    np.testing.assert_array_equal(port_fma(p, w, c), exact_fma(p, w, c))


# ---- combine_taps against JAX at the grids' tiny-weight pixels ----


def _tiny_pixels(pipeline):
    """(JAX grid, port grid) over the warp grid's pixels whose smallest
    nonzero weight is below 2^-20, each pixel on its own 2x2 window of a
    (2, 2n) source: the weights and the arithmetic are the grid's."""
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    g = j_step.TrackerParams.build(*args, pipeline=pipeline).grid_warp_roi
    ws = [np.asarray(getattr(g, k)).reshape(-1)
          for k in ("w00", "w01", "w10", "w11")]
    tiny = np.zeros(ws[0].shape, bool)
    for w in ws:
        tiny |= (w != 0) & (np.abs(w) < TINY)
    idx = np.flatnonzero(tiny)
    n = len(idx)
    base = (2 * np.arange(n, dtype=np.int32)).reshape(1, n)
    sub = [w[idx].reshape(1, n) for w in ws]
    jg = j_resample.ResampleGrid(jnp.asarray(base),
                                 *(jnp.asarray(w) for w in sub),
                                 src_size=(2 * n, 2))
    tg = t_resample.ResampleGrid(base, *sub, src_size=(2 * n, 2))
    # The port's own grid holds the same weights at those pixels.
    tp = t_step.TrackerParams.build(*args, pipeline=pipeline, device="cpu")
    np.testing.assert_array_equal(tp.grid_warp_roi.w00.numpy()[idx], sub[0][0])
    return jg, tg, n


def _sources(taps):
    """(T, 2, 2n, 3) images from taps (T, n, 4, 3): pixel i's window is
    columns 2i, 2i + 1 of both rows."""
    T, n = taps.shape[:2]
    img = np.zeros((T, 2, 2 * n, 3), np.uint8)
    img[:, 0, 0::2], img[:, 0, 1::2] = taps[:, :, 0], taps[:, :, 1]
    img[:, 1, 0::2], img[:, 1, 1::2] = taps[:, :, 2], taps[:, :, 3]
    return img


def _near_ties(tg, n, rng, per_pixel=4096, keep=48):
    """Per pixel, of ``per_pixel`` random tap sets the ``keep`` whose f32
    sum (the port's chain, before rint) lies nearest a .5 tie."""
    taps = rng.integers(0, 256, (per_pixel, n, 4, 3)).astype(np.uint8)
    t = torch.from_numpy(taps)
    ws = [w[:, None] for w in (tg.w00, tg.w01, tg.w10, tg.w11)]
    acc = (t[:, :, 1].double() * ws[1]).float()
    for slot, w in ((0, ws[0]), (2, ws[2]), (3, ws[3])):
        acc = t_resample.fma_f32(t[:, :, slot], w, acc)
    dist = (acc - torch.floor(acc) - 0.5).abs().amin(-1).numpy()
    order = np.argsort(dist, axis=0)[:keep]  # (keep, n)
    return np.take_along_axis(taps, order[:, :, None, None], axis=0)


@pytest.mark.parametrize("pipeline", ["corridor", "fast"])
def test_combine_taps_equals_jax_at_tiny_weights(pipeline):
    jg, tg, n = _tiny_pixels(pipeline)
    assert n > 0
    rng = np.random.default_rng(n)
    sweeps = {"random": rng.integers(0, 256, (64, n, 4, 3)).astype(np.uint8),
              "near_ties": _near_ties(tg, n, rng)}
    run = jax.jit(jax.vmap(lambda img: j_resample.bilinear_gather(img, jg)))
    for name, taps in sweeps.items():
        img = _sources(taps)
        want = np.asarray(run(img))
        got = t_resample.bilinear_gather(torch.from_numpy(img), tg).numpy()
        assert got.shape == want.shape == (len(taps), 1, n, 3)
        for c, ch in enumerate("RGB"):
            n_diff = int((got[..., c] != want[..., c]).sum())
            assert n_diff == 0, (pipeline, name, ch, n_diff)


# ---- where combine_taps may skip the correction ----


def test_needs_fma_flags_tiny_weights_and_large_sums():
    """A pixel needs the correction where a nonzero weight is below 2^-20
    or the weights sum above 4; zero weights never do."""
    w = np.array([[0.25, 0.0, TINY, TINY / 2, 0.0, 1.0],
                  [0.25, 0.0, 0.5, 0.5, 0.0, 1.0],
                  [0.25, 0.0, 0.5, 0.0, -TINY / 4, 1.0],
                  [0.25, 0.0, 0.0, 0.0, 0.0, 1.5]], np.float32)
    got = t_resample.needs_fma(*w)
    np.testing.assert_array_equal(got, [False, False, False, True, True, True])


def _port_warp_grid(pipeline):
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    return t_step.TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline=pipeline, device="cpu").grid_warp_roi


@pytest.mark.parametrize("pipeline", ["corridor", "fast"])
def test_combine_taps_float64_sum_exact_where_unflagged(pipeline):
    """On the whole warp grid, with taps at 0, 1, 254, 255 and random: at
    every pixel outside ``grid.rounded`` each float64 multiply-add of the
    chain is exact (its TwoSum residual is 0), so its one f32 rounding is
    the fma's; and combine_taps equals the chain of ``fma_f32`` everywhere."""
    g = _port_warp_grid(pipeline)
    n = g.base.numel()
    assert 0 < g.rounded.numel() < n // 1000
    rng = np.random.default_rng(len(pipeline))
    vals = np.array([0, 1, 254, 255], np.uint8)
    taps = [torch.from_numpy(np.concatenate(
        [vals[rng.integers(0, 4, (1, n, 3))],
         rng.integers(0, 256, (1, n, 3)).astype(np.uint8)]))
        for _ in range(4)]
    ws = [w[:, None] for w in (g.w00, g.w01, g.w10, g.w11)]
    free = torch.ones(n, dtype=torch.bool)
    free[g.rounded] = False
    acc = (taps[1] * ws[1]).float()
    for p, w in ((taps[0], ws[0]), (taps[2], ws[2]), (taps[3], ws[3])):
        a = p * w
        s = a + acc
        bb = s - a
        e = (a - (s - bb)) + (acc - bb)
        assert int((e[:, free] != 0).sum()) == 0
        acc = s.float()
    chain = t_resample._fma_chain(*taps, ws)
    want = torch.round(chain).clamp_(0, 255).to(torch.uint8)
    assert torch.equal(t_resample.combine_taps(*taps, g), want)
