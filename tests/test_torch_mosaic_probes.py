"""The shift-chain twins against the morphology probes' Pallas kernels.

scripts/mosaic_probe.py, mosaic_probe2.py, mosaic_probe3.py and
mosaic_probe4.py are loaded by path and their ``main()`` runs on the CPU at
a small size (H=40, W=256, K=8; the margins and scratch shapes follow from
them as in the scripts), with ``pallas_call`` in interpret mode and
``device_time_per_iter`` replaced by a function that runs the body once
and keeps its input and output.  Each printed row without an error is
paired with the output captured for it; probe 4's full-size tophat rows
are made to print errors (``tophat_pallas2`` raises here: it is held
against JAX in tests/test_filter_stage2.py and its port in
tests/test_torch_filter_kernels.py).

Every row of the port's table (kernels/shift_chain.VARIANTS) must equal
its probe's: the same names, the same rejected variant, the same input,
and ``shift_chain_plain`` on that input equal to the captured output.
Tolerance: exact, 0 mismatches (integer bodies wrap alike; bf16 rounds
after every op in both).  The integer add chains run again at K=32, where
every integer type's adds wrap (at K=8 the int16 and most int32 chains
stay in range).  The CUDA kernels are held against these twins
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import functools
import io
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, set up by tests/conftest.py)
from jax.experimental import pallas as pl

import lane_tracker_tpu.kernels.filter_stage2 as filter_stage2
import lane_tracker_tpu.utils.timing as timing

from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.kernels import shift_chain as sc
from lane_tracker_tpu_torch.kernels import sweep_dots as sd
from lane_tracker_tpu_torch.kernels import tile_gather as tg
from lane_tracker_tpu_torch.probes import mosaic
from torch_scripts import load_script

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = {1: "mosaic_probe", 2: "mosaic_probe2", 3: "mosaic_probe3",
           4: "mosaic_probe4"}
H, W, K = 40, 256, 8
WRAP_K = 32
INT_ADDS = [v.name for v in sc.VARIANTS
            if v.dtype in ("uint8", "int8", "int16", "int32")
            and v.body in ("add", "add_self", "addshift", "packed")
            and not v.rejected]


def _tophat_unavailable(*args, **kwargs):
    raise RuntimeError("full-size tophat not run here")


def _run_probe(n, k, only=None):
    """(printed rows, {variant: (x0, out) or its error message}) of the
    probe's chains of k passes; with ``only``, the other variants' bodies
    are not run (their entries are None)."""
    mod = load_script(SCRIPTS[n])
    # The timer is called once per chain row, in the table's order (which
    # test_table_names_and_rejections_equal_probe holds to the probe's); a
    # rejected row's body raises in it and keeps nothing.
    names = iter([v.name for v in sc.VARIANTS if v.probe == n])
    captured = []

    def timer(init, body, n_iters=None, repeats=None):
        name = next(names)
        x0 = init()
        captured.append((name, None) if only is not None and name not in only
                        else (name, (np.asarray(x0), np.asarray(body(x0)))))
        return 1.0, None

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("H", H), ("W", W), ("K", k)):
            mp.setattr(mod, name, value)
        if hasattr(mod, "MY"):
            mp.setattr(mod, "PH", H + 2 * mod.MY)
            mp.setattr(mod, "PW", W + 2 * mod.MX)
        if n == 4:
            mp.setattr(mod, "T", 1)
            mp.setattr(filter_stage2, "tophat_pallas2", _tophat_unavailable)
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(timing, "device_time_per_iter", timer)
        with contextlib.redirect_stdout(out):
            mod.main()
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    results, outputs = {}, iter(captured)
    for row in rows:
        if "error" in row:
            results[row["variant"]] = row["error"]
            continue
        name, got = next(outputs)
        assert name == row["variant"], "an output paired with another row"
        results[name] = got
    assert next(outputs, None) is None, "an output without its row"
    return rows, results


@pytest.fixture(scope="module")
def probes():
    cache = {}

    def get(n, k=K):
        if (n, k) not in cache:
            cache[n, k] = _run_probe(n, k, None if k == K else INT_ADDS)
        return cache[n, k]
    return get


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _chain_rows(rows, n):
    """The probe's printed shift-chain rows (probe 4 also prints tophat
    rows, which are not chains)."""
    return [r for r in rows
            if not (n == 4 and r["variant"].startswith("tophat"))]


@pytest.mark.parametrize("name", [v.name for v in sc.VARIANTS])
def test_variant_equals_probe(probes, name):
    v = sc.BY_NAME[name]
    _, results = probes(v.probe)
    got = results[name]
    if v.rejected:
        assert isinstance(got, str), "the probe ran a variant the port rejects"
        with pytest.raises(ValueError, match=name):
            sc.shift_chain_plain(sc.make_input(v, H, W), v, K)
        return
    assert not isinstance(got, str), f"the probe failed: {got}"
    x0, want = got
    x = _tensor(x0)
    assert x.dtype == sc.DTYPES[v.dtype]
    assert torch.equal(x, sc.make_input(v, H, W))
    out = sc.shift_chain_plain(x, v, K)
    want = _tensor(want)
    assert out.dtype == want.dtype and out.shape == want.shape
    n = int((out.double() != want.double()).sum())
    assert n == 0, f"{n} of {want.numel()} values differ"


@pytest.mark.parametrize("name", INT_ADDS)
def test_integer_add_variant_wraps_like_probe(probes, name):
    v = sc.BY_NAME[name]
    x0, want = probes(v.probe, WRAP_K)[1][name]
    out = sc.shift_chain_plain(_tensor(x0), v, WRAP_K)
    n = int((out.long() != _tensor(want).long()).sum())
    assert n == 0, f"{n} of {out.numel()} values differ"


def test_integer_adds_wrap_in_every_type(probes):
    """An add chain from values >= 0 never falls below its input unless it
    wraps: at WRAP_K every integer type with add rows does."""
    wrapped = set()
    for name in INT_ADDS:
        v = sc.BY_NAME[name]
        x0, want = probes(v.probe, WRAP_K)[1][name]
        if (_tensor(want).long() < _tensor(x0).long()).any():
            wrapped.add(v.dtype)
    assert wrapped == {sc.BY_NAME[name].dtype for name in INT_ADDS} == {
        "uint8", "int16", "int32"}


def test_kernel_instances_are_the_tables_cases():
    """csrc/shift_chain*.cu instantiate lt_shift_chain for exactly the
    (type, body, boundary, axis) cases the runnable variants name, each
    case in one source's CASE list."""
    csrc = REPO / "lane_tracker_tpu_torch" / "csrc"
    text = "".join(p.read_text()
                   for p in sorted(csrc.glob("shift_chain*.cu")))
    c_type = {"uint8_t": "uint8", "int8_t": "int8", "int16_t": "int16",
              "int32_t": "int32", "bf16": "bfloat16", "float": "float32"}
    c_body = {"k" + "".join(w.capitalize() for w in b.split("_")): b
              for b in sc._BODY_CODE}
    c_bound = {"kNone": None, "kCircular": "circular", "kFill": "fill"}
    cases = [(c_type[t], c_body[b], c_bound[bd], int(ax)) for t, b, bd, ax in
             re.findall(r"^  CASE\((\w+), (\w+), (\w+), (\d)\)$",
                        text, re.M)]
    assert len(cases) == len(set(cases))
    assert set(cases) == {
        (v.dtype, v.body, v.boundary, 1 if v.axis is None else v.axis)
        for v in sc.VARIANTS
        if not v.rejected and v.body != "morph_chain8"}


@pytest.mark.parametrize("n", sorted(SCRIPTS))
def test_table_names_and_rejections_equal_probe(probes, n):
    rows = _chain_rows(probes(n)[0], n)
    assert [v.name for v in sc.VARIANTS if v.probe == n] == [
        r["variant"] for r in rows]
    assert [v.name for v in sc.VARIANTS if v.probe == n and v.rejected] == [
        r["variant"] for r in rows if "error" in r]


def test_table_counts():
    assert [sum(v.probe == n for v in sc.VARIANTS) for n in SCRIPTS] == [
        19, 24, 16, 6]
    assert [v.name for v in sc.VARIANTS if v.rejected] == [
        "i16_sublane_slice_add_s17"]
    assert len(sc.BY_NAME) == 65


def test_wrapper_takes_twin_on_cpu_without_counting():
    sc.reset_launches()
    for v in sc.VARIANTS:
        if v.rejected:
            with pytest.raises(ValueError):
                sc.shift_chain(sc.make_input(v, 16, 64), v, 4)
            continue
        x = sc.make_input(v, 16, 64)
        torch.testing.assert_close(sc.shift_chain(x, v, 4),
                                   sc.shift_chain_plain(x, v, 4),
                                   rtol=0, atol=0)
    assert sc.LAUNCHES == {"shift_chain": 0, "shift_chain_2d": 0}


def test_probe_path_runs_on_cpu_at_a_small_size():
    """probes.mosaic.run's control flow, on the plain twins: every row
    that runs agrees, the rejected one prints its error, nothing counts."""
    sc.reset_launches()
    fs.reset_launches()
    sd.reset_launches()
    tg.reset_launches()
    rows = mosaic.run("cpu", h=24, w=48, k=4, tophat_t=1,
                      tophat_hw=(40, 72), dual_t=1,
                      overlap_shape=(1, 48, 160), overlap_dims=(16, 64, 64))
    names = [mosaic.row_name(r) for r in rows]
    assert names == [v.name for v in sc.VARIANTS] + [
        "tophat29", "tophat55", "tophat29_bf16", "tophat55_bf16",
        "tophat29_f32", "sweeps", "dots", "both", "separate_29_55",
        "dual"] + list(tg.OPS)
    assert [r["variant"] for r in rows if "error" in r] == [
        "i16_sublane_slice_add_s17"]
    assert all(mosaic.row_ok(r) for r in rows if "error" not in r)
    assert next(r for r in rows if r.get("stage") == "dual")["block"] == "n/a"
    assert sc.LAUNCHES == {"shift_chain": 0, "shift_chain_2d": 0}
    assert not any(fs.LAUNCHES.values())
    assert sd.LAUNCHES == {"sweep_dots": 0}
    assert tg.LAUNCHES == {"tile_gather": 0}
    assert all(r["launches"] == 0 for r in rows
               if r.get("kernel") in ("sweep_dots", "tile_gather"))


def test_probe_path_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mosaic.run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mosaic.main([])


@pytest.mark.parametrize("bad", ["dtype", "rank", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    x = sc.make_input(sc.BY_NAME["i32_lane_roll_add_s1"], 8, 32)
    if bad == "dtype":
        x = x.short()
    elif bad == "rank":
        x = x[None]
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        sc.shift_chain(x, "i32_lane_roll_add_s1", 4)
