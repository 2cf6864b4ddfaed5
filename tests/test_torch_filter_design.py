"""The redesigned filter kernels' decompositions against the plain twins.

``tests/torch_filter_models.py`` models ``lt_tophat``'s and
``lt_cross_threshold``'s kernels in numpy (tiles, halos, fills, buffers,
the widening plan, the walkers).  Here each model equals its plain twin
exactly on random ragged inputs, for every k the wrappers take: odd k in
1..63 for the tophat (at several output tiles, buffers starting as random
bytes), k in 1..65 for the threshold (plain, with the noise keep-mask, and
with the merge epilogue).  The tophat model also equals JAX's
``tophat_pallas2`` in interpret mode at k=29 and 55, in
tests/test_torch_filter_kernels.py.  The wrappers' limits on the card are
checked too, and that the CPU twins take any k.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_filter_models import (
    half_widths,
    threshold_model,
    tophat_model,
    tophat_steps,
)

from lane_tracker_tpu.ops import morphology as j_morph

from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.ops.threshold import cross_threshold

TOPHAT_K = list(range(1, fs.TOPHAT_MAX_K + 1, 2))
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


@pytest.mark.parametrize("k", range(1, 66))
def test_threshold_model_equals_twin(k):
    img = _ragged(7 * k, T=2)
    # Flat regions around 120 so hits and misses both occur.
    img = (img // 4 + 100).astype(np.uint8)
    rng = np.random.default_rng(k)
    merge_r = (rng.random(img.shape) < 0.2).astype(np.uint8) * 255
    keep = (rng.random(img.shape) < 0.8).astype(np.uint8) * 255
    t = torch.from_numpy(img)
    C = int(rng.integers(-6, 6))
    for nt, mr, kp in ((-1, None, None), (110, None, None),
                       (-1, merge_r, keep), (-1, merge_r, None)):
        want = cross_threshold(t, k, C, nt)
        if mr is not None:
            hit = (want > 0) | torch.from_numpy(mr > 0)
            if kp is not None:
                hit &= torch.from_numpy(kp > 0)
            want = torch.where(hit, 255, 0).to(torch.uint8)
        got = threshold_model(img, k, C, nt, mr, kp)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"k={k}")


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
    before any launch.  On the CPU the twin answers at every k >= 1, equal
    to JAX's tophat_ellipse (k = 0 is no ellipse: both refuse it)."""
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
