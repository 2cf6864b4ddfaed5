"""Probe 6's port (kernels/sweep_dots.py) against its Pallas kernel.

scripts/mosaic_probe6.py is loaded by path and its ``main()`` runs on the
CPU at T=2, ROWS=48, COLS=256, BLOCK=32, KP=NP=128 (the products' tiles
stay multiples of 16), with ``pallas_call`` in interpret mode and wrapped
so that a ``jax.debug.callback`` records the kernel's inputs and its
output inside the jitted call (the timed body returns a mix of the output,
not the output), and ``device_time_per_iter`` replaced by a stub.  For
each kind the recorded ``out`` must match ``sweep_dots`` on the CPU (its
plain twin) on the same ``default_rng(0)`` input.  Tolerance: exact for
``sweeps`` (the sum of bf16 values of that size is exact in f32 and in
float64); relative 1e-5 for ``dots`` and ``both``, where JAX sums the f32
products in f32 and the twin in float64.  The twin's sweeps also equal a
numpy model that rounds each f32 sum to bf16 by hand.  The kernel's wgmma
tile plan (tests/torch_filter_models.py's ``sweep_dots_tiles``) covers
each (block row, K column, tri column) product exactly once, at the
probe's size and on ragged shapes, and the float64 sum of its tiles'
products plus the corner equals the twin's out within ``sd.RTOL``.  The
CUDA kernel is held against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import lane_tracker_tpu.utils.timing as timing

from lane_tracker_tpu_torch.kernels import sweep_dots as sd
from lane_tracker_tpu_torch.probes import mosaic
from torch_filter_models import sweep_dots_products, sweep_dots_tiles
from torch_scripts import in_trace_order, load_script, recording_pallas_call

SMALL = {"T": 2, "ROWS": 48, "COLS": 256, "BLOCK": 32, "KP": 128, "NP": 128}
DOTS_RTOL = 1e-5


@pytest.fixture(scope="module")
def probe6():
    """(printed rows, [(x, tri, out)] per kind in the probe's order)."""
    mod = load_script("mosaic_probe6")
    captured = {}
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(mod, name, value)
        mp.setattr(pl, "pallas_call", recording_pallas_call(captured))
        mp.setattr(timing, "device_time_per_iter",
                   lambda *a, **k: (1.0, None))
        with contextlib.redirect_stdout(out):
            mod.main()
        jax.effects_barrier()
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    return rows, in_trace_order(captured)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _small_inputs():
    s = SMALL
    return sd.make_inputs(s["T"], s["ROWS"], s["COLS"], s["KP"], s["NP"])


def test_probe6_ran_every_kind(probe6):
    rows, captured = probe6
    assert [r["kind"] for r in rows] == list(sd.KINDS)
    assert not any("error" in r for r in rows)
    assert len(captured) == len(sd.KINDS)


def test_probe6_inputs_equal_ports(probe6):
    x, tri = _small_inputs()
    for got_x, got_tri, _ in probe6[1]:
        assert torch.equal(_bf16(got_x), x)
        assert torch.equal(_bf16(got_tri), tri)


@pytest.mark.parametrize("kind", list(sd.KINDS))
def test_twin_equals_probe6(probe6, kind):
    _, _, want = probe6[1][list(sd.KINDS).index(kind)]
    x, tri = _small_inputs()
    sd.reset_launches()
    got, swept = sd.sweep_dots(x, tri, kind, block=SMALL["BLOCK"])
    assert sd.LAUNCHES == {"sweep_dots": 0}
    assert got.shape == want.shape == (SMALL["T"], 1, 1)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    want = torch.from_numpy(np.array(want))
    if kind == "sweeps":
        assert torch.equal(got, want)
        assert not torch.equal(swept, x)
    else:
        torch.testing.assert_close(got, want, rtol=DOTS_RTOL, atol=0)
        assert torch.equal(swept, x) == (kind == "dots")


def _numpy_sweeps(x: np.ndarray, sweeps: int) -> np.ndarray:
    """The sweeps in float32, each f32 sum rounded to bf16 by hand (round
    to nearest even on the upper 16 bits)."""
    scr = x.astype(np.float32)
    m = scr.shape[1] - sd.UNSWEPT
    for i in range(sweeps):
        d = i % 7 + 1
        acc = np.minimum(scr[:, :m], scr[:, d:d + m]) + np.float32(1.0)
        bits = acc.view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
        scr[:, :m] = bits.astype(np.uint32).view(np.float32)
    return scr


def test_twin_sweeps_equal_numpy_model():
    x, tri = _small_inputs()
    _, swept = sd.sweep_dots_plain(x, tri, "both", block=SMALL["BLOCK"])
    want = _numpy_sweeps(x.float().numpy(), sd.SWEEPS)
    assert np.array_equal(swept.float().numpy(), want)
    assert np.array_equal(want[:, -sd.UNSWEPT:], x.float().numpy()[:, -8:])


# (frame, tri, block, col0): the probe's frame width and row block (tiles
# of 184 rows) at a reduced product depth and width, and a ragged frame
# whose last strip is 22 columns wide and whose products start and end
# inside strips (tiles of 8 rows).
PLANS = {"probe": ((2, 400, 1280), (96, 128), sd.BLOCK, sd.COL0),
         "ragged": ((3, 61, 150), (96, 64), 32, 16)}


@pytest.mark.parametrize("case", list(PLANS))
def test_tile_plan_covers_each_product_once(case):
    (_, _, cols), (kp, n), block, col0 = PLANS[case]
    tiles = sweep_dots_tiles(cols, col0, kp, n, block)
    count = np.zeros((sd.N_BLOCKS, block, kp, n), np.uint8)
    for _, _, mt, k0, j, n0, nt in tiles:
        count[j, n0:n0 + nt, k0 - col0:k0 - col0 + 16,
              64 * mt:64 * (mt + 1)] += 1
    assert (count == 1).all()


def test_tile_plan_at_full_size_is_one_product_of_partitions():
    """At (32, 600, 1280), KP = NP = 1152: the m tiles, K steps and each
    block's n tiles partition their ranges, and the plan is their product
    with no tile twice (a dense count would take 1.5 G cells)."""
    tiles = sweep_dots_tiles(sd.COLS, sd.COL0, sd.KP, sd.NP, sd.BLOCK)
    assert len(set(tiles)) == len(tiles)
    ms = sorted({mt for _, _, mt, *_ in tiles})
    ks = sorted({k0 for _, _, _, k0, *_ in tiles})
    ns = sorted({(n0, nt) for *_, n0, nt in tiles})
    assert ms == list(range(sd.NP // 64))
    assert ks == list(range(sd.COL0, sd.COL0 + sd.KP, 16))
    assert ns == [(0, 184), (184, 184)]
    assert len(tiles) == len(ms) * len(ks) * sd.N_BLOCKS * len(ns)
    assert {g for _, g, mt, *_ in tiles} == {0, 1}
    assert all(mt % 2 == g for _, g, mt, *_ in tiles)


@pytest.mark.parametrize("case", list(PLANS))
def test_tile_plan_sum_equals_twin(case):
    (t, h, w), (kp, n), block, col0 = PLANS[case]
    x, tri = sd.make_inputs(t, h, w, kp, n)
    want, swept = sd.sweep_dots_plain(x, tri, "both", block=block,
                                      col0=col0)
    scr = swept.double().numpy()
    got = sweep_dots_products(
        scr, tri.double().numpy(), sweep_dots_tiles(w, col0, kp, n, block),
        col0) + scr[:, :8, :128].sum((1, 2))
    np.testing.assert_allclose(got, want.double().view(-1).numpy(),
                               rtol=sd.RTOL, atol=0)


BAD = {  # (frame, tri, block, col0): each breaks one rule
    "block_not_16": ((1, 64, 256), (128, 128), 24, 64),
    "kp_not_16": ((1, 64, 256), (120, 128), 32, 64),
    "np_not_16": ((1, 64, 256), (128, 136), 32, 64),
    "np_not_64": ((1, 64, 256), (128, 96), 32, 64),
    "rows_long": ((1, 609, 256), (128, 128), 32, 64),
    "col0_not_16": ((1, 64, 256), (128, 128), 32, 8),
    "rows_short": ((1, 47, 256), (128, 128), 32, 64),
    "cols_short": ((1, 64, 191), (128, 128), 32, 64),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_rejects_shape_before_launch(case):
    shape, tri_shape, block, col0 = BAD[case]
    x = torch.zeros(shape, dtype=torch.bfloat16)
    tri = torch.zeros(tri_shape, dtype=torch.bfloat16)
    sd.reset_launches()
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError):
            sd.sweep_dots(x.to(device), tri.to(device), "both", block=block,
                          col0=col0)
    assert sd.LAUNCHES == {"sweep_dots": 0}


def test_wrapper_rejects_kind_and_dtype():
    x, tri = _small_inputs()
    with pytest.raises(ValueError, match="kind"):
        sd.sweep_dots(x, tri, "neither", block=32)
    with pytest.raises(ValueError, match="bf16"):
        sd.sweep_dots(x.float(), tri, "both", block=32)


def test_full_size_shapes_pass_validation():
    """368 and 1152 are 23 and 72 tiles of 16, 1152 is 18 of 64, and
    they fit the (600, 1280) frame: the probe's own call validates."""
    x = torch.empty((1, sd.ROWS, sd.COLS), dtype=torch.bfloat16,
                    device="meta")
    tri = torch.empty((sd.KP, sd.NP), dtype=torch.bfloat16, device="meta")
    sd._validate(x, tri, "both", sd.BLOCK, sd.COL0, sd.SWEEPS)


def test_probe_rows_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (mosaic.overlap_rows, mosaic.gather_rows):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
