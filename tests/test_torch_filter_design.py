"""The redesigned filter kernels' decompositions against the plain twins.

``tests/torch_filter_models.py`` models ``lt_tophat``'s and
``lt_cross_threshold``'s kernels in numpy (tiles, halos, fills, buffers,
the widening plan, the walkers).  Here each model equals its plain twin
exactly on random ragged inputs, for every k the wrappers take: odd k in
1..63 for the tophat (at several output tiles, buffers starting as random
bytes), k in 1..65 for the threshold (plain and with the noise
keep-mask).  The tophat's tile with its planes in u8, bf16 and f32 lanes
(``lt_tophat``, ``lt_tophat_staged``) equals the twin at k = 3, 29 and 55
at small tiles and at the planned one; the host planner's mirror fits
each CTA shape for every odd k and lane width, and the dual tophat's grid
(``lt_dual_tophat``) covers every output of both problems once, the
larger k's tiles first.  The tophat model also equals JAX's
``tophat_pallas2`` in interpret mode at k=29 and 55, in
tests/test_torch_filter_kernels.py.  The bit-packed merge + open + prefix
tail's model equals ``merge_open_plain`` (binary and packed prefixes) for
every odd open_k in 1..63, with and without keep, at W = 672, 1080 and 101
(no multiple of 16 or 32), H below a band's 32 rows and across bands, and
``thr_merge_open_plain`` as the tail (the merge in its load) of the
threshold model's output.  The adaptive mean's model (128-column tiles,
replicate-clamped staging, uint16 row walkers, column walkers writing in
place) equals ``adaptive_mean_plain`` for every odd k up to the kernel's
127 at W = 672, 1080 and 101, T = 1 and 2, at the planned tile height and
the tallest; the fused channel stage's model (cs_plan's tiles, the
staged plane walked for the noise mask then refilled, the tophat of the
threshold's read region, its walkers) equals ``channel_stage_plain`` for
demo1's R and B + noise on ragged shapes, and its plan covers every
output once with the halos the arms and the ellipse reach.  The wrappers'
limits on the card are checked too, and that the CPU twins take any k.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_filter_models import (
    CS_THREADS,
    ELEMS,
    TOP_SHAPES,
    TOP_THREADS,
    adaptive_mean_model,
    adaptive_mean_rows,
    channel_stage_model,
    cs_plan,
    dual_tiles,
    half_widths,
    open_tail_model,
    plane_guard,
    threshold_model,
    tophat_model,
    tophat_plan,
    tophat_steps,
)

from lane_tracker_tpu.ops import morphology as j_morph

from lane_tracker_tpu_torch.kernels import channel_fused as cf
from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.tracker.config import PRESETS
from lane_tracker_tpu_torch.ops.threshold import cross_threshold

TOPHAT_K = list(range(1, fs.TOPHAT_MAX_K + 1, 2))
OPEN_K = list(range(1, fs.OPEN_MAX_K + 1, 2))
# (T, H, W): the corridor's width with H below a band, the 'fast' width
# across two bands, a width no multiple of 16 or 32 across three.
OPEN_SHAPES = [(1, 20, 672), (1, 40, 1080), (2, 70, 101)]
# (tile width, tile height): the planner's extremes and a middle one.
TILES = [(64, 8), (128, 48), (256, 16)]


def _ragged(seed, T=1):
    rng = np.random.default_rng(seed)
    H, W = int(rng.integers(5, 70)), int(rng.integers(1, 150))
    img = rng.integers(0, 256, (T, H, W)).astype(np.uint8)
    # Bright stripes and flat blocks, so the opening keeps and removes.
    for _ in range(3):
        c = int(rng.integers(0, W))
        img[:, :, c:c + int(rng.integers(1, 6))] //= 3
    return img


def test_tophat_plan_widens_exactly():
    """Each widening step stays within its exactness limit (shift <= 2h +
    1), every row distance is gathered exactly once, at its own
    half-width, and the plan fits the kernel's table."""
    for k in TOPHAT_K:
        w = half_widths(k)
        steps = tophat_steps(k)
        assert len(steps) <= fs.TOPHAT_MAX_STEPS
        h, seen = 0, []
        for s, lo, hi, need in steps:
            assert 0 <= s <= 2 * h + 1
            h += s
            seen += [(d, h) for d in range(lo, hi + 1)]
            assert need >= hi
        assert sorted(seen) == [(d, w[d]) for d in range(len(w))], k
        assert h == w[0]


@pytest.mark.parametrize("k", TOPHAT_K)
def test_tophat_model_equals_twin(k):
    rng = np.random.default_rng(k)
    for i, (tw, th) in enumerate(TILES):
        img = _ragged(100 * k + i, T=1 + i % 2)
        want = fs.tophat_ellipse_plain(torch.from_numpy(img), k).numpy()
        got = tophat_model(img, k, tw, th, rng)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} {tw}x{th}")


@pytest.mark.parametrize("k", [3, 29, 55])
@pytest.mark.parametrize("elem", ELEMS)
def test_tophat_model_equals_twin_in_each_lane_width(elem, k):
    """The tile with its planes in u8, bf16 or f32 lanes (16, 8 or 4
    pixels a quad): at four and eight quads by 8 and 48 rows, and at the
    planned tile of the ragged frame."""
    rng = np.random.default_rng(10 * k + elem)
    P = 16 // elem
    for i in range(3):
        img = _ragged(1000 * elem + 10 * k + i, T=1 + i % 2)
        T, H, W = img.shape
        tiles = [(4 * P, 8), (8 * P, 48), tuple(
            tophat_plan(k, H, W, elem)[key] for key in ("tw", "th"))]
        want = fs.tophat_ellipse_plain(torch.from_numpy(img), k).numpy()
        tw, th = tiles[i]
        got = tophat_model(img, k, tw, th, rng, elem)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"k={k} elem={elem} {tw}x{th}")


@pytest.mark.parametrize("elem", ELEMS)
def test_tophat_plan_fits_its_shape(elem):
    """For every odd k and frames from tiny to the probes' 1100 x 1080:
    the plan's tile is whole quads, its buffers hold 2 elem bytes a staged
    pixel and fit its CTA shape's shared memory, its threads hold the
    eroded region and the tile; u8 takes two CTAs an SM (lt_tophat's
    tiles: 192 x 160 at k=29, 128 x 104 at k=55 on the corridor)."""
    for k in TOPHAT_K:
        for H, W in ((1100, 1080), (1100, 672), (37, 101), (5, 3)):
            p = tophat_plan(k, H, W, elem)
            quads, _, limit = TOP_SHAPES[p["shape"]]
            r, P = k // 2, 16 // elem
            assert p["tw"] == P * p["tq"] and p["rq"] * P >= r
            staged = (p["th"] + 4 * r) * (p["tq"] + 4 * p["rq"]) * P
            assert p["smem"] - 2 * elem * staged == 64 * plane_guard(elem)
            assert p["smem"] <= limit
            cap = quads * TOP_THREADS
            assert (p["th"] + 2 * r) * (p["tq"] + 2 * p["rq"]) <= cap
            assert p["th"] * p["tq"] <= cap
            assert elem > 1 or p["shape"] == 0
    assert [tophat_plan(k, 1100, 672)[key] for k in (29, 55)
            for key in ("tw", "th")] == [192, 160, 128, 104]


@pytest.mark.parametrize("ks", [(29, 55), (55, 29), (3, 3), (63, 1)])
@pytest.mark.parametrize("shape", [(2, 77, 101), (3, 1100, 1080),
                                   (1, 5, 3)])
def test_dual_grid_covers_each_output_once(shape, ks):
    """Every output pixel of both problems lies in exactly one block's
    tile, each problem's tiles in one run, the larger k's first."""
    T, H, W = shape
    ka, kb = ks
    tiles = dual_tiles(ka, kb, T, H, W)
    cover = np.zeros((2, T, H, W), int)
    for prob, z, by, bx in tiles:
        p = tophat_plan((ka, kb)[prob], H, W)
        cover[prob, z, by * p["th"]:(by + 1) * p["th"],
              bx * p["tw"]:(bx + 1) * p["tw"]] += 1
    assert (cover == 1).all()
    probs = [t[0] for t in tiles]
    first = 1 if kb > ka else 0
    n_first = probs.count(first)
    assert probs == [first] * n_first + [1 - first] * (len(probs) - n_first)


@pytest.mark.parametrize("k", range(1, 66))
def test_threshold_model_equals_twin(k):
    img = _ragged(7 * k, T=2)
    # Flat regions around 120 so hits and misses both occur.
    img = (img // 4 + 100).astype(np.uint8)
    rng = np.random.default_rng(k)
    t = torch.from_numpy(img)
    C = int(rng.integers(-6, 6))
    for nt in (-1, 110):
        want = cross_threshold(t, k, C, nt)
        got = threshold_model(img, k, C, nt)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"k={k}")


def _blobs(rng, shape, noise=0.002):
    """0/255 masks of random rectangles, some past the edges, sparse
    flipped pixels in the left half, and a full-height block on the right
    edge: every opening up to k=63 keeps some pixels and removes others."""
    T, H, W = shape
    x = np.zeros(shape, np.uint8)
    for t in range(T):
        for _ in range(6):
            h, w = int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1))
            y, c = int(rng.integers(-h // 2, H)), int(rng.integers(-w // 2, W))
            x[t, max(y, 0):y + h, max(c, 0):c + w] = 255
        x[t, :, :W // 2][rng.random((H, W // 2)) < noise] ^= 255
        x[t, :, W - W // 3:] = 255
    return x


def _keep(rng, shape):
    """255 but for sparse zeros in the left half."""
    keep = np.full(shape, 255, np.uint8)
    half = keep[..., :shape[-1] // 2]
    half[rng.random(half.shape) < 0.003] = 0
    return keep


@pytest.mark.parametrize("k", OPEN_K)
def test_open_tail_model_equals_twin(k):
    """Every odd open_k the card takes, with and without keep; b's nonzero
    bytes are not only 255 (the merge tests nonzero)."""
    rng = np.random.default_rng(1000 + k)
    for shape in OPEN_SHAPES:
        a = _blobs(rng, shape)
        b = _blobs(rng, shape) // rng.integers(1, 255, shape).astype(np.uint8)
        keep = _keep(rng, shape)
        for kp in (keep, None):
            want = fs.merge_open_plain(
                torch.from_numpy(a), torch.from_numpy(b),
                None if kp is None else torch.from_numpy(kp), k)
            got = open_tail_model(a, b, kp, k)
            assert want[0].any() and not want[0].all()
            np.testing.assert_array_equal(got[0], want[0].numpy(),
                                          err_msg=f"k={k} {shape}")
            np.testing.assert_array_equal(got[1], want[1].packed.numpy(),
                                          err_msg=f"k={k} {shape}")


@pytest.mark.parametrize("kb,open_k", [(35, 5), (5, 3), (65, 63)])
def test_open_tail_model_is_thr_merge_open_tail(kb, open_k):
    """lt_thr_merge_open's two launches: the tail, merging R and keep in
    its load, of the threshold model's output equals the twin."""
    rng = np.random.default_rng(kb)
    for shape in OPEN_SHAPES[::2]:
        b_feat = rng.integers(90, 140, shape).astype(np.uint8)
        r_th = _blobs(rng, shape)
        keep = _keep(rng, shape)
        got = open_tail_model(r_th, threshold_model(b_feat, kb, 2), keep,
                              open_k)
        want = fs.thr_merge_open_plain(
            torch.from_numpy(r_th), torch.from_numpy(b_feat), kb, 2,
            torch.from_numpy(keep), open_k)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].packed.numpy())


def _no_launch(*args, **kwargs):
    raise AssertionError("a kernel library was loaded for a refused k")


def _as_if_on_card(monkeypatch):
    """The wrappers take their CUDA branch for CPU tensors, and any
    launch fails the test: what a card would see before launching."""
    monkeypatch.setattr(fs, "_on_cuda", lambda *imgs: True)
    monkeypatch.setattr(fs, "load_library", _no_launch)
    fs.reset_launches()


@pytest.mark.parametrize("k", [0, 2, 28, fs.TOPHAT_MAX_K + 2])
def test_tophat_wrapper_rejects_k_before_launch(k, monkeypatch):
    """On the card, even k (asymmetric runs) and k above 63 are refused
    before any launch, by every tophat entry (the staged and dual ones
    too).  On the CPU the twin answers at every k >= 1, equal to JAX's
    tophat_ellipse (k = 0 is no ellipse: both refuse it)."""
    img = _ragged(k, T=2)
    x = torch.from_numpy(img)
    if k >= 1:
        want = np.stack([np.asarray(j_morph.tophat_ellipse(jnp.asarray(f), k))
                         for f in img])
        np.testing.assert_array_equal(fs.tophat_ellipse(x, k).numpy(), want)
        got, = fs.tophat_riders(x, k, [])
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        with pytest.raises(ValueError, match="ksize"):
            fs.tophat_ellipse(x, k)
    _as_if_on_card(monkeypatch)
    with pytest.raises(ValueError, match="ksize"):
        fs.tophat_ellipse(x, k)
    with pytest.raises(ValueError, match="ksize"):
        fs.tophat_riders(x, k, [])
    for dtype in fs.STAGING:
        with pytest.raises(ValueError, match="ksize"):
            fs.tophat_staged(x, k, dtype)
    for ka, kb in ((k, 29), (29, k)):
        with pytest.raises(ValueError, match="ksize"):
            fs.dual_tophat(x, x, ka, kb)
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES}


@pytest.mark.parametrize("k", [0, fs.THRESHOLD_MAX_K + 1])
def test_threshold_wrapper_rejects_k_before_launch(k, monkeypatch):
    """On the card, k = 0 and k above 128 are refused before any launch
    (a rider's k before the tophat launches); on the CPU the twins answer."""
    x = torch.from_numpy(_ragged(k + 1, T=2))
    want = cross_threshold(x, k, 5)
    assert torch.equal(fs.bilateral_threshold(x, k, 5), want)
    assert torch.equal(fs.tophat_riders(x, 29, [(x, k, 5, -1)])[1], want)
    got, _ = fs.thr_merge_open(x, x, k, 5)
    assert torch.equal(got, fs.thr_merge_open_plain(x, x, k, 5)[0])
    _as_if_on_card(monkeypatch)
    with pytest.raises(ValueError, match="ksize"):
        fs.bilateral_threshold(x, k, 5)
    with pytest.raises(ValueError, match="ksize"):
        fs.tophat_riders(x, 29, [(x, k, 5, -1)])
    with pytest.raises(ValueError, match="ksize"):
        fs.thr_merge_open(x, x, k, 5)
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES}


@pytest.mark.parametrize("k", [0, 2, 30, fs.OPEN_MAX_K + 2])
def test_open_wrappers_reject_k_before_launch(k, monkeypatch):
    """On the card, an even open_k or one above 63 (a half-width past one
    neighbour word) is refused before any launch, by merge_open and by
    thr_merge_open; on the CPU the twins answer at every k >= 1."""
    x = torch.from_numpy(_ragged(k + 3, T=2))
    if k >= 1:
        want = fs.merge_open_plain(x, x, None, k)
        got = fs.merge_open(x, x, None, k)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].packed, want[1].packed)
        got = fs.thr_merge_open(x, x, 5, 2, None, k)
        assert torch.equal(got[0], fs.thr_merge_open_plain(x, x, 5, 2, None,
                                                           k)[0])
    _as_if_on_card(monkeypatch)
    with pytest.raises(ValueError, match="ksize"):
        fs.merge_open(x, x, None, k)
    with pytest.raises(ValueError, match="ksize"):
        fs.thr_merge_open(x, x, 5, 2, None, k)
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES}


ADAPTIVE_K = list(range(1, fs.ADAPTIVE_MEAN_MAX_K + 1, 2))
# (T, H, W): the corridor's width, the 'fast' width, a width no multiple
# of 16; T = 1 as 'cond' runs it.
ADAPTIVE_SHAPES = [(1, 21, 672), (2, 19, 1080), (1, 37, 101)]


@pytest.mark.parametrize("k", ADAPTIVE_K)
def test_adaptive_mean_model_equals_twin(k):
    """Every odd k the card takes, each shape at its planned tile height
    (16 here) and the first at the tallest (128), with C past the
    clamp on the last shape."""
    rng = np.random.default_rng(2000 + k)
    for i, shape in enumerate(ADAPTIVE_SHAPES):
        img = _ragged(3000 + k + i, T=shape[0])
        img = np.resize(img, shape).astype(np.uint8)
        C = (-5, 4, 300)[i]
        want = fs.adaptive_mean_plain(torch.from_numpy(img), k, C).numpy()
        for th in {adaptive_mean_rows(*shape), 128} if i == 0 else {
                adaptive_mean_rows(*shape)}:
            got = adaptive_mean_model(img, k, C, th, rng)
            np.testing.assert_array_equal(got, want, err_msg=f"k={k} {th}")


def test_adaptive_mean_rows_fill_the_card():
    """The fallback's batch takes 128-row tiles; 'cond''s T=1 frame the
    tallest whose grid gives all 132 SMs a CTA."""
    assert adaptive_mean_rows(64, 1100, 672) == 128
    assert adaptive_mean_rows(1, 1100, 672) == 32
    assert adaptive_mean_rows(1, 5, 5) == 16


_F = PRESETS["demo1"].filter
CS_CHANNELS = {
    "R": (_F.tophat_r, _F.ksize_r, _F.C_r, None),
    "B": (_F.tophat_b, _F.ksize_b, _F.C_b,
          (_F.ksize_noise, _F.C_noise, _F.noise_thresh)),
}


@pytest.mark.parametrize("shape", [(2, 77, 101), (1, 20, 30), (1, 300, 5)])
@pytest.mark.parametrize("chan", ["R", "B"])
def test_channel_stage_model_equals_twin(chan, shape):
    """demo1's arguments at the planned tile and at 7-row tiles, buffers
    starting as random bytes."""
    kt, kb, C, noise = CS_CHANNELS[chan]
    rng = np.random.default_rng(sum(shape))
    img = (_ragged(sum(shape), T=shape[0]) // 2 + 100).astype(np.uint8)
    img = np.resize(img, shape).astype(np.uint8)
    img[..., ::17] = 250  # bright columns: the tophat and arms both hit
    want = cf.channel_stage_plain(torch.from_numpy(img), kt, kb, C,
                                  noise=noise)
    want = want if noise else (want,)
    for block in (0, 7):
        got = channel_stage_model(img, kt, kb, C, noise, block, rng)
        got = got if noise else (got,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=str(block))


@pytest.mark.parametrize("block", [0, 1, 33, 10 ** 6])
@pytest.mark.parametrize("shape", [(1100, 672), (1100, 1080), (77, 101)])
def test_channel_stage_plan_covers_outputs_once(shape, block):
    """The grid covers each output once; the staged halo reaches every
    pixel the tophat of the threshold's read region and the noise arms
    read; the buffers fit one CTA and the held quads its threads."""
    H, W = shape
    for kt, kb, _, noise in CS_CHANNELS.values():
        kn = noise[0] if noise else 0
        p = cs_plan(kt, kb, kn, H, W, block)
        tw, th, r = 16 * p["tq"], p["th"], p["r"]
        cover = np.zeros((H, W), int)
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                cover[y0:y0 + th, x0:x0 + tw] += 1
        assert (cover == 1).all()
        assert p["hy"] >= max(kb + 2 * r, kn)
        assert 16 * p["hq"] >= max(16 * p["kbq"] + 2 * r, kn)
        assert 16 * p["kbq"] >= kb
        quads, _, smem, _ = p["shape"]
        assert p["smem"] <= smem
        thd, tqd = th + 2 * kb, p["tq"] + 2 * p["kbq"]
        assert (thd + 2 * r) * (tqd + 2 * p["rq"]) <= quads * CS_THREADS
        assert block == 0 or th == min(block, H) or th < block
