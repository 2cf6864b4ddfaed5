"""The reader of ``upload_streamed_share`` on canned program summaries:
the streamed frames over ``lt.frames`` in the three offline cells, and
nothing where the program counts no streamed frames (a program without
the streamed upload, or the CPU, which copies the chunk whole), ran no
frame or gave no stretch; the fleet cell does not read it."""

import pathlib
import types

import pytest

from benchmark import cell, trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = cell.load_benchmark(ROOT)
NAME = "upload_streamed_share"
OFFLINE = ("offline-demo1.motion-drop", "offline-corridor-demo1.motion-drop",
           "offline-demo1.motion-clean")
FLEET = "fleet16-demo1.motion-clean"


def summary(streamed=None, frames=512):
    counters = {"lt.frames": frames, "lt.host_reads": 2}
    if streamed is not None:
        counters["lt.upload.streamed_frames"] = streamed
    return {"spans": {}, "counters": counters, "units": 1}


def read(program, name):
    reader = cell.readers(HERE, BENCH, name)[NAME]
    return reader.read(types.SimpleNamespace(program=program))


@pytest.mark.parametrize("name", OFFLINE)
@pytest.mark.parametrize("streamed, share", [(512, 1.0), (128, 0.25),
                                             (0, 0.0)])
def test_the_share_of_streamed_frames(name, streamed, share):
    assert read(summary(streamed), name) == share


@pytest.mark.parametrize("program", [None, summary(), summary(0, frames=0)])
def test_nothing_without_the_counter_or_frames(program):
    assert read(program, OFFLINE[0]) is None
    bare = trace.TraceReading([], 2, 1.0, {})
    assert cell.readers(HERE, BENCH, OFFLINE[0])[NAME].read(bare) is None


def test_the_fleet_cell_does_not_read_it():
    assert NAME not in cell.readers(HERE, BENCH, FLEET)
