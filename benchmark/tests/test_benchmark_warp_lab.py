"""The reader of ``warp_lab_kernel_share`` on canned program summaries:
the kernel frames over ``lt.frames`` in every cell, and nothing where the
program counts no kernel frames (a program without the kernels, or the
CPU, which runs the PyTorch chain), ran no frame or gave no stretch."""

import pathlib
import types

import pytest

from benchmark import cell, trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = cell.load_benchmark(ROOT)
NAME = "warp_lab_kernel_share"
CELLS = ("offline-demo1.motion-drop", "fleet16-demo1.motion-clean",
         "offline-corridor-demo1.motion-drop", "offline-demo1.motion-clean")


def summary(kernel=None, frames=512):
    counters = {"lt.frames": frames, "lt.host_reads": 2}
    if kernel is not None:
        counters["lt.warp_lab.kernel_frames"] = kernel
    return {"spans": {}, "counters": counters, "units": 1}


def read(program, name):
    reader = cell.readers(HERE, BENCH, name)[NAME]
    return reader.read(types.SimpleNamespace(program=program))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kernel, share", [(512, 1.0), (128, 0.25),
                                           (0, 0.0)])
def test_the_share_of_kernel_frames(name, kernel, share):
    assert read(summary(kernel), name) == share


@pytest.mark.parametrize("program", [None, summary(), summary(0, frames=0)])
def test_nothing_without_the_counter_or_frames(program):
    assert read(program, CELLS[0]) is None
    bare = trace.TraceReading([], 2, 1.0, {})
    assert cell.readers(HERE, BENCH, CELLS[0])[NAME].read(bare) is None


def test_every_cell_reads_it():
    for name in CELLS:
        assert NAME in cell.readers(HERE, BENCH, name)
