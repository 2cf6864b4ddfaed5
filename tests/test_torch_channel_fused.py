"""The fused channel stage's plain twins against the JAX scripts' kernels.

scripts/channel_fused_postmortem.py is loaded by path (as
tests/test_longrun.py loads scripts/motion_longrun.py), and its Pallas
kernels ``channel_stage_pallas2`` and ``channel_stage_pyr_pallas2`` run in
interpret mode on the CPU.  Inputs are made from a seed with numpy: uint8
channels with bright vertical stripes, so the tophat, the threshold and
the noise mask all have hits and misses.  Configurations: demo1's R
(kt, kb, C) = (29, 15, 8), and its LAB-B (55, 35, 5) with the noise mask
(kn, Cn, nthr) = (65, 10, 140); shapes: a ragged (2, 72, 96) and a
(1, 20, 30) smaller than the 65-pixel noise arm.

Tolerance: exact equality, 0 mismatches (the chain is integer).  The CUDA
kernel is held against these twins on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, set up by tests/conftest.py)

from lane_tracker_tpu_torch.kernels import channel_fused as cf
from lane_tracker_tpu_torch.tracker.config import PRESETS
from torch_scripts import load_script

F = PRESETS["demo1"].filter
CHANNELS = {
    "R": (F.tophat_r, F.ksize_r, F.C_r, None),
    "B": (F.tophat_b, F.ksize_b, F.C_b,
          (F.ksize_noise, F.C_noise, F.noise_thresh)),
}
SHAPES = [(2, 72, 96), (1, 20, 30)]


@pytest.fixture(scope="module")
def postmortem():
    return load_script("channel_fused_postmortem")


def stripes(shape, seed):
    """uint8 channels in [100, 200) with bright vertical stripes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(100, 200, shape).astype(np.int32)
    for t in range(shape[0]):
        for _ in range(3):
            c = int(rng.integers(0, shape[2]))
            x[t, :, c:c + int(rng.integers(2, 9))] += int(rng.integers(30, 60))
    return np.clip(x, 0, 255).astype(np.uint8)


def _assert_same(got: torch.Tensor, want, both_classes=True):
    want = np.asarray(want)
    n = int((got.numpy() != want).sum())
    assert n == 0, f"{n} of {want.size} values differ"
    if both_classes:
        assert 0 < (want > 0).mean() < 1


def test_config_is_demo1():
    assert CHANNELS["R"][:3] == (29, 15, 8)
    assert CHANNELS["B"] == (55, 35, 5, (65, 10, 140))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chan", ["R", "B"])
def test_channel_stage_twin_equals_pallas(postmortem, chan, shape):
    kt, kb, C, noise = CHANNELS[chan]
    img = stripes(shape, sum(shape))
    want = postmortem.channel_stage_pallas2(img, kt, kb, C, noise=noise,
                                            interpret=True)
    got = cf.channel_stage_plain(torch.from_numpy(img), kt, kb, C,
                                 noise=noise)
    if noise is None:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    # The keep-mask of an image narrower than its 65-pixel arms is all 255:
    # the zero border pulls every arm sum under the bar.
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, both_classes=i == 0 or shape[2] > 2 * noise[0])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chan", ["R", "B"])
def test_channel_stage_pyr_twin_equals_pallas(postmortem, chan, shape):
    kt, kb, C, _ = CHANNELS[chan]
    img = stripes(shape, sum(shape) + 1)
    want = postmortem.channel_stage_pyr_pallas2(img, kt, kb, C,
                                                interpret=True)
    _assert_same(cf.channel_stage_pyr_plain(torch.from_numpy(img), kt, kb, C),
                 want)


def test_wrappers_take_twins_on_cpu_without_counting():
    img = torch.from_numpy(stripes((2, 40, 48), 7))
    kt, kb, C, noise = CHANNELS["B"]
    cf.reset_launches()
    for got, want in (
            (cf.channel_stage(img, kt, kb, C, noise=noise, block=8),
             cf.channel_stage_plain(img, kt, kb, C, noise=noise)),
            (cf.channel_stage(img[1], kt, kb, C, noise=noise),
             cf.channel_stage_plain(img[1], kt, kb, C, noise=noise)),
            ((cf.channel_stage_pyr(img, kt, kb, C),),
             (cf.channel_stage_pyr_plain(img, kt, kb, C),))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[0].shape == (2, 40, 48)
    assert cf.LAUNCHES == {"channel_stage": 0, "channel_stage_pyr": 0}


@pytest.mark.parametrize("bad", ["dtype", "rank", "device"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.zeros((2, 40, 48), dtype=torch.uint8)
    if bad == "dtype":
        x = x.int()
    elif bad == "rank":
        x = x[None]
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        cf.channel_stage(x, 29, 15, 8)
