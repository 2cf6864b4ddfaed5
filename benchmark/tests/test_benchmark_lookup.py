"""The harness finds configurations, mixes, entries and metrics by file
name, so that a later cell or metric is new files and a new entry only."""

import json
import pathlib
import shutil

import pytest

from benchmark import cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = cell.load_benchmark(ROOT)


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_parts_by_name(wl):
    cfg = cell.config(HERE, wl["config"])
    assert cfg["name"] == wl["config"]
    mix = cell.mix(HERE, wl["traffic"])
    assert hasattr(cell.generator(HERE, mix), "make_pools")
    assert hasattr(cell.entry(HERE, cfg), "Entry")
    readers = cell.readers(HERE, BENCH, wl["name"])
    listed = [m["name"] for m in cell.metrics(BENCH, "per_layer", wl["name"])]
    assert sorted(readers) == sorted(listed)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_file_declares_its_entry(m):
    mod = cell.load_module(HERE / "metrics" / f"{m['name']}.py", "t")
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        m["name"], m["unit"], m["layer"], m["source"], m["moves"])
    assert callable(mod.read)


def test_a_name_with_a_slash_is_refused():
    with pytest.raises(ValueError):
        cell.config(HERE, "../configs/offline-demo1")


def test_unknown_workload():
    with pytest.raises(KeyError):
        cell.workload(BENCH, "no-such.cell")


def test_a_new_mix_and_metric_are_new_files_only(tmp_path):
    """In a copy: a dummy mix, a dummy per-layer metric and a workload entry
    that uses them; the harness finds both without an edit to any file
    that was there."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    mix = json.loads((HERE / "traffic" / "motion-clean.json").read_text())
    mix.update(pool_frames=8, scene_order=[2])
    (tmp_path / "benchmark" / "traffic" / "dummy-mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "dummy_frames.py").write_text(
        'NAME = "dummy_frames"\nUNIT = "frames"\nLAYER = "device"\n'
        'SOURCE = "program_counter"\nMOVES = "frames_per_s"\n\n\n'
        'def read(trace):\n    return trace.frames\n')
    name = "offline-demo1.dummy-mix"
    bench["workloads"].append({"name": name, "config": "offline-demo1",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy_frames", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    here = tmp_path / "benchmark"
    loaded = cell.load_benchmark(tmp_path)
    wl = cell.workload(loaded, name)
    found = cell.mix(here, wl["traffic"])
    assert found["scene_order"] == [2]
    gen = cell.generator(here, found)
    assert [s for _, s in gen.pool_plan(found, 1)[0]] == [2] * 8
    readers = cell.readers(here, loaded, name)
    assert "dummy_frames" in readers
    for p, data in before.items():
        assert p.read_bytes() == data
