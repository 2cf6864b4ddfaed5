"""The port's motion frames against ``scripts/motion_longrun.motion_sequence``.

``lane_tracker_tpu_torch.io.motion`` makes bench.py's BENCH_MOTION=1
frames with torch, by OpenCV 5's float32 ``warpAffine`` arithmetic, with
no OpenCV or PIL.  Held here, on the CPU:

* every value of frames t = 0, 8, 37, 150, 233, 300, 517, 640, 899, 1000
  and 1199 (all three scenes) and of the dropout frames 451 and 901 equal
  to the script's (cv2 and PIL): 0 values differ;
* the forward matrix and its inverse equal ``cv2.getRotationMatrix2D``
  and ``cv2.invertAffineTransform`` bit for bit;
* ``fma_f32`` correctly rounded against exact ``fractions.Fraction``
  arithmetic on hypothesis-drawn float32 triples;
* ``motion_chunk`` stacks ``motion_sequence``'s frames, and the default
  device is the card (without CUDA it raises).
"""

import fractions
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import cv2

from tests.test_torch_fma import f32_round
from tests.torch_scripts import REPO, load_script

from lane_tracker_tpu_torch.io import motion
from lane_tracker_tpu_torch.kernels.resample import fma_f32

SAMPLED = (0, 8, 37, 150, 233, 300, 517, 640, 899, 1000, 1199)
DROPOUT = (451, 901)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Full-size frames through PyTorch's CPU operators: with the suite's
    workers sharing the cores, the intra-op thread pool makes each far
    dearer than the work.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script_frames():
    """The script's frames at SAMPLED + DROPOUT (it opens ``assets/`` by a
    path relative to the repo root)."""
    want = set(SAMPLED + DROPOUT)
    here = os.getcwd()
    os.chdir(REPO)
    try:
        gen = load_script("motion_longrun").motion_sequence(max(want) + 1)
        return {t: f for t, f in gen if t in want}
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def scenes():
    return motion.load_scenes("cpu")


@pytest.mark.parametrize("t", SAMPLED + DROPOUT)
def test_frame_equals_opencv(script_frames, scenes, t):
    got = motion.motion_frame(t, scenes).numpy()
    want = script_frames[t]
    assert got.shape == want.shape == (720, 1280, 3)
    assert got.dtype == want.dtype == np.uint8
    assert motion.is_dropout(t) == (t in DROPOUT)
    n = int((got != want).sum())
    assert n == 0, f"t={t}: {n} values differ from cv2.warpAffine"


@pytest.mark.parametrize("t", SAMPLED + (1, 2, 55, 173, 211, 777))
def test_matrices_equal_opencv_bit_for_bit(t):
    W, H = 1280, 720
    dx, dy, ang, zoom = motion.jitter(t)
    want = cv2.getRotationMatrix2D((W / 2, H / 2), ang, zoom)
    got = motion.rotation_matrix((W / 2, H / 2), ang, zoom)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    want[:, 2] += (dx, dy)
    got = motion.frame_matrix(t, W, H)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    inv = cv2.invertAffineTransform(want)
    assert np.array_equal(motion.invert_affine(got).view(np.int64),
                          inv.view(np.int64))


# f32 values of magnitude 2^-50 to 2^20, either sign, or zero: every
# product and sum stays in f32's normal range, where f32_round is exact.
F32 = st.one_of(st.just(0.0), st.tuples(
    st.floats(min_value=2.0 ** -50, max_value=2.0 ** 20, width=32),
    st.booleans()).map(lambda m: -m[0] if m[1] else m[0]))


@settings(max_examples=300, deadline=None, derandomize=True,
          database=None)
@given(st.lists(st.tuples(F32, F32, F32), min_size=1, max_size=32))
def test_fma_f32_correctly_rounded(triples):
    """fma_f32 on float32 tensors: the f32 nearest the exact a*b + c."""
    a, b, c = (np.array(v, np.float32) for v in zip(*triples))
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([
        f32_round(fractions.Fraction(float(x)) * fractions.Fraction(float(y))
                  + fractions.Fraction(float(z)))
        for x, y, z in zip(a, b, c)], np.float32)
    assert got.dtype == np.float32
    # Exact zeros compare by value (f32_round gives +0 for a -0 sum).
    np.testing.assert_array_equal(got, want)


def test_chunk_stacks_the_sequence():
    seq = [f for _, f in motion.motion_sequence(3, device="cpu")]
    chunk = motion.motion_chunk(3, device="cpu")
    assert chunk.shape == (3, 720, 1280, 3) and chunk.dtype == torch.uint8
    assert all(torch.equal(chunk[i], seq[i]) for i in range(3))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        motion.motion_chunk(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(motion.motion_sequence(1))
