"""The staged and the dual tophat against probes 5 and 10's Pallas kernels.

scripts/mosaic_probe5.py (the production tophat with bf16 or f32 compute
scratch) runs its ``main()`` on the CPU at T=1 (one full 1100x1080 frame),
with ``pallas_call`` in interpret mode and its timer replaced: all three of
its variants must print ``exact: true``.  ``tophat_staged`` in each staging
type, on the CPU its plain twin, must equal JAX's ``tophat_ellipse`` on
the same ``default_rng(1)`` frame.  scripts/mosaic_probe10.py's
``build_dual`` (two tophats, k=29 and k=55, in one kernel) runs in
interpret mode at (2, 72, 96) and on a ragged (2, 77, 101) with 24-row
blocks; ``dual_tophat`` on the CPU must equal it.  Inputs are made with
numpy from a seed.  Tolerance: exact, 0 mismatches (integer morphology).
The CUDA kernels are held against these twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import functools
import io
import json

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import lane_tracker_tpu.utils.timing as timing
from lane_tracker_tpu.ops.morphology import tophat_ellipse as j_tophat

from lane_tracker_tpu_torch.kernels import filter_stage as fs
from torch_scripts import load_script


@pytest.fixture(scope="module")
def probe5_rows():
    mod = load_script("mosaic_probe5")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "T", 1)
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(timing, "device_time_per_iter",
                   lambda init, body, n_iters=None, repeats=None: (1.0, None))
        with contextlib.redirect_stdout(out):
            mod.main()
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def frame():
    """Probe 5's input at T=1: default_rng(1), (1, 1100, 1080) uint8."""
    return np.random.default_rng(1).integers(0, 256, (1, 1100, 1080), np.uint8)


@pytest.fixture(scope="module")
def jax_tophat(frame):
    cache = {}

    def get(k):
        if k not in cache:
            cache[k] = np.asarray(jax.jit(j_tophat, static_argnums=1)(
                frame[0], k))[None]
        return cache[k]
    return get


def test_probe5_is_exact(probe5_rows):
    assert [(r["variant"], r.get("exact")) for r in probe5_rows] == [
        ("tophat29_bf16", True), ("tophat55_bf16", True),
        ("tophat29_f32", True)]


@pytest.mark.parametrize("k,dtype", [(29, torch.bfloat16),
                                     (55, torch.bfloat16),
                                     (29, torch.float32), (55, torch.float32)])
def test_tophat_staged_twin_equals_jax(frame, jax_tophat, k, dtype):
    fs.reset_launches()
    got = fs.tophat_staged(torch.from_numpy(frame), k, dtype)
    want = jax_tophat(k)
    n = int((got.numpy() != want).sum())
    assert n == 0, f"{n} of {want.size} values differ"
    assert 0 < (want > 0).mean() < 1
    assert fs.LAUNCHES["tophat_staged"] == 0


def test_tophat_staged_rejects_other_types(frame):
    with pytest.raises(ValueError, match="staging"):
        fs.tophat_staged(torch.from_numpy(frame), 29, torch.uint8)


@pytest.mark.parametrize("shape", [(2, 72, 96), (2, 77, 101)])
def test_dual_tophat_twin_equals_build_dual(shape):
    probe10 = load_script("mosaic_probe10")
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = rng.integers(100, 200, shape).astype(np.uint8)
    T, H, W = shape
    want_a, want_b = probe10.build_dual(H, W, 29, 55, 24, interpret=True)(a, b)
    fs.reset_launches()
    got_a, got_b = fs.dual_tophat(torch.from_numpy(a), torch.from_numpy(b),
                                  29, 55)
    for got, want in ((got_a, want_a), (got_b, want_b)):
        want = np.asarray(want)
        n = int((got.numpy() != want).sum())
        assert n == 0, f"{n} of {want.size} values differ"
        assert 0 < (want > 0).mean() < 1
    assert fs.LAUNCHES["dual_tophat"] == 0
