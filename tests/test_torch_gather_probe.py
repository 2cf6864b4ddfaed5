"""Probe 11's port (kernels/tile_gather.py) against its Pallas kernel.

scripts/mosaic_probe11.py is loaded by path and its ``main()`` runs on the
CPU at its fixed size, (128, 1280) int32, with ``pallas_call`` in
interpret mode and wrapped so that a ``jax.debug.callback`` records the
kernel's inputs and output inside the jitted call (the timed body returns
``s ^ (max(o) & 1)``, not the output), and ``device_time_per_iter``
replaced by a stub that runs the body once on each variant's reps=16 call
and skips its reps=64 call (a 64-rep body takes minutes to trace here).
The stub traces the body where ``main()`` calls it and compiles and runs
it in a worker thread, so that XLA compiles one op's body (most of the
fixture's time) while the next op's body is traced.  All four recorded outputs must equal ``tile_gather`` on the CPU (its plain
twin) on the same ``default_rng(0)`` inputs, bit for bit.  At both chain
lengths the twin must equal a numpy ``take_along_axis`` model that walks
the tiles one by one.  Tolerance: exact, 0 mismatches (integer).  The CUDA
kernel is held against the twin on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import concurrent.futures
import contextlib
import io
import itertools
import json

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import lane_tracker_tpu.utils.timing as timing

from lane_tracker_tpu_torch.kernels import tile_gather as tg
from torch_scripts import in_trace_order, load_script, recording_pallas_call

OPS = list(tg.OPS)


@pytest.fixture(scope="module")
def probe11():
    """(printed rows, [(src, li, si, out)] per op at reps=16)."""
    mod = load_script("mosaic_probe11")
    captured = {}
    calls = itertools.count()
    runs = []

    def timer(make_carry, body, n_iters=None, repeats=None, invariant=None):
        if next(calls) % 2 == 0:  # each variant's reps=16 call
            lowered = jax.jit(body).lower(make_carry())
            runs.append(pool.submit(lambda: jax.block_until_ready(
                lowered.compile()(make_carry()))))
        return 1.0, None

    out = io.StringIO()
    with (pytest.MonkeyPatch.context() as mp,
          concurrent.futures.ThreadPoolExecutor(len(OPS)) as pool):
        mp.setattr(pl, "pallas_call", recording_pallas_call(captured))
        mp.setattr(timing, "device_time_per_iter", timer)
        with contextlib.redirect_stdout(out):
            mod.main()
        for run in runs:
            run.result()
        jax.effects_barrier()
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    return rows, in_trace_order(captured)


def test_probe11_ran_every_op(probe11):
    rows, captured = probe11
    assert [r["probe"] for r in rows] == OPS
    assert not any("err" in r for r in rows)
    assert len(captured) == len(OPS)


def test_probe11_inputs_equal_ports(probe11):
    want = tg.make_inputs()
    for rec in probe11[1]:
        for got, w in zip(rec[:3], want):
            assert got.dtype == np.int32
            assert torch.equal(torch.from_numpy(np.array(got)), w)


@pytest.mark.parametrize("op", OPS)
def test_twin_equals_probe11(probe11, op):
    want = torch.from_numpy(np.array(probe11[1][OPS.index(op)][3]))
    tg.reset_launches()
    got = tg.tile_gather(*tg.make_inputs(), op, tg.REPS[0])
    assert tg.LAUNCHES == {"tile_gather": 0}
    assert got.dtype == want.dtype == torch.int32
    n = int((got != want).sum())
    assert n == 0, f"{n} of {want.numel()} values differ"
    assert 0 < int(got.max()) <= tg.MASK


def _numpy_chain(src, li, si, op, reps):
    """The probe's chain on each (8, 128) tile with take_along_axis."""
    out = np.zeros_like(src)
    for g in range(src.shape[0] // 8):
        for w in range(src.shape[1] // 128):
            t = np.s_[8 * g:8 * g + 8, 128 * w:128 * w + 128]
            prev = np.zeros((8, 128), np.int32)
            for _ in range(reps):
                v = src[t] + prev
                if op in ("G1_lane_gather", "G3_2d_gather"):
                    v = np.take_along_axis(v, li[t], axis=1)
                if op in ("G2_sublane_gather", "G3_2d_gather"):
                    v = np.take_along_axis(v, si[t], axis=0)
                prev = v & tg.MASK
            out[t] = prev
    return out


@pytest.mark.parametrize("reps", tg.REPS)
@pytest.mark.parametrize("op", OPS)
def test_twin_equals_numpy_model(op, reps):
    src, li, si = tg.make_inputs()
    got = tg.tile_gather_plain(src, li, si, op, reps)
    want = _numpy_chain(src.numpy(), li.numpy(), si.numpy(), op, reps)
    assert np.array_equal(got.numpy(), want)


def test_g3_reads_li_at_the_gathered_row():
    """G3 is v[si[r, c], li[si[r, c], c]]: a lane index that differs by
    row moves the output only through the row si picks."""
    src = torch.arange(8 * 128, dtype=torch.int32).view(8, 128) * 3
    li = torch.zeros((8, 128), dtype=torch.int32)
    li[5] = 7  # only row 5 gathers lane 7
    si = torch.full((8, 128), 5, dtype=torch.int32)
    got = tg.tile_gather_plain(src, li, si, "G3_2d_gather", 1)
    assert torch.equal(got, torch.full((8, 128), int(src[5, 7]) & tg.MASK,
                                       dtype=torch.int32))


@pytest.mark.parametrize("bad", ["shape", "dtype", "op", "reps"])
def test_wrapper_rejects_bad_inputs(bad):
    src, li, si = (a[:16, :256].contiguous() for a in tg.make_inputs())
    op, reps = "G1_lane_gather", 4
    if bad == "shape":
        src, li, si = (a[:12] for a in (src, li, si))
    elif bad == "dtype":
        li = li.long()
    elif bad == "op":
        op = "G4"
    else:
        reps = -1
    tg.reset_launches()
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError):
            tg.tile_gather(src.to(device), li.to(device), si.to(device), op,
                           reps)
    assert tg.LAUNCHES == {"tile_gather": 0}
