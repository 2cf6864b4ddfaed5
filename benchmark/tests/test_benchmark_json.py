"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def _all_names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            yield entry["name"]
    for wl in BENCH["workloads"]:
        yield wl["config"]
        yield wl["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_all_names())))
def test_names_keep_to_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric) <= allowed
    for w in metric.get("workloads", []):
        assert w in {wl["name"] for wl in BENCH["workloads"]}


def test_unique_names_and_setup():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_parts_exist(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] in (1, 4)
    assert 1 <= len(wl["why"]) <= 200
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    assert (ROOT / "benchmark" / "configs" / f"{wl['config']}.json").is_file()
    mix = json.loads((ROOT / "benchmark" / "traffic"
                      / f"{wl['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "traffic"
            / f"{mix['generator']}.py").is_file()
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{wl['config']}.json").read_text())
    assert (ROOT / "benchmark" / "entries" / f"{cfg['entry']}.py").is_file()


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    assert len(c["reduced"]) <= 16
    assert c["source"].startswith("https://")
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_sources_differ():
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(sources) == len(set(sources))


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for wl in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if wl["name"] in m.get("workloads", [wl["name"]])]
        layer = [m["name"] for m in BENCH["per_layer"]
                 if wl["name"] in m.get("workloads", [wl["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_run_seconds_fit_a_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
