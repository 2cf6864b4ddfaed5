"""The kernel wrappers launch on their inputs' device, and refuse inputs
on two devices.

The C launchers take the stream they are given, but read the current
device (``cudaGetDevice``) and set their kernels' shared-memory
attributes on it (``cudaFuncSetAttribute``): a wrapper must make its
inputs' device current and launch on that device's current stream, or a
shard on ``cuda:1`` launched while ``cuda:0`` is current would run on the
wrong card.  Held here without a card: ``filter_stage._call`` makes the
given device current and passes that device's stream; no module but it
reads a current stream; every wrapper with two inputs raises on inputs
on two devices before any kernel or twin runs (one on the CPU, one on
PyTorch's ``meta`` device).  tests/test_torch_cuda.py holds the same on
the card.
"""

import contextlib
import pathlib
import re
import types

import pytest
import torch

from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.kernels import resample_mxu2 as rm
from lane_tracker_tpu_torch.kernels import sweep_dots as sd
from lane_tracker_tpu_torch.kernels import tile_gather as tg

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / (
    "lane_tracker_tpu_torch")


def test_call_makes_the_inputs_device_current(monkeypatch):
    current = [torch.device("cuda", 0)]
    calls = []

    @contextlib.contextmanager
    def device(d):
        prev, current[0] = current[0], torch.device(d)
        try:
            yield
        finally:
            current[0] = prev

    def current_stream(d=None):
        return types.SimpleNamespace(cuda_stream=1000 + torch.device(d).index)

    def lt_entry(*args):
        calls.append((current[0], args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    fs._call(torch.device("cuda", 1), lt_entry, 7, 8)
    assert calls == [(torch.device("cuda", 1), (7, 8, 1001))]
    assert current[0] == torch.device("cuda", 0)  # restored

    def lt_failing(*args):
        return 700

    with pytest.raises(RuntimeError, match="lt_failing failed: CUDA error "
                                           "700"):
        fs._call(torch.device("cuda", 1), lt_failing)


def test_only_call_reads_a_current_stream():
    """Every launcher goes through ``filter_stage._call``: no other code of
    the package reads a current stream (the one without a device would
    be the current device's)."""
    hits = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"current_stream\(|cuda_stream", line):
                hits.append(f"{path.relative_to(PACKAGE)}:{n}")
    assert len(hits) == 1 and hits[0].startswith("kernels/filter_stage.py")


def _u8(device, shape=(1, 8, 8)):
    return torch.zeros(shape, dtype=torch.uint8, device=device)


TWO_DEVICE_CALLS = {
    "tophat_riders": lambda a, b: fs.tophat_riders(a, 29, [(b, 15, 8, -1)]),
    "thr_merge_open": lambda a, b: fs.thr_merge_open(a, b, 35, 5),
    "thr_merge_open_keep": lambda a, b: fs.thr_merge_open(a, a, 35, 5, b),
    "merge_open": lambda a, b: fs.merge_open(a, b),
    "dual_tophat": lambda a, b: fs.dual_tophat(a, b, 29, 55),
    "sweep_dots": lambda a, b: sd.sweep_dots(
        *(x.to(d) for x, d in zip(sd.make_inputs(t=1), (a.device,
                                                          b.device))),
        "sweeps"),
    "tile_gather": lambda a, b: tg.tile_gather(
        *(x.to(d) for x, d in zip(tg.make_inputs(),
                                  (a.device, b.device, a.device))),
        "B0_plain_add", 1),
    "banded_pass2": lambda a, b: rm.pass2(
        torch.zeros((1, 1, 2, 8), device=a.device),
        torch.zeros((2, 1, 4, rm.LANE), device=b.device), 4),
}


@pytest.mark.parametrize("name", sorted(TWO_DEVICE_CALLS))
def test_wrappers_reject_inputs_on_two_devices(monkeypatch, name):
    def never(*args, **kwargs):
        raise AssertionError("launched or computed")

    monkeypatch.setattr(fs, "_call", never)
    for mod in (fs, sd, tg, rm):
        for twin in [n for n in dir(mod) if n.endswith("_plain")]:
            monkeypatch.setattr(mod, twin, never)
    with pytest.raises(ValueError, match="device"):
        TWO_DEVICE_CALLS[name](_u8("cpu"), _u8("meta"))
