"""Find a cell's parts by name: BENCHMARK.json, its configuration, its
traffic mix, its entry, its generator and its per-layer readers.

Everything that belongs to one configuration, mix or metric is a file of
its own, found from the names in BENCHMARK.json:

* ``configs/<config>.json``, whose ``entry`` names ``entries/<entry>.py``;
* ``traffic/<traffic>.json``, whose ``generator`` names
  ``traffic/<generator>.py``;
* ``metrics/<metric>.py`` for each ``per_layer`` metric.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def config(here: pathlib.Path, name: str) -> dict:
    return json.loads((here / "configs" / f"{_checked(name)}.json")
                      .read_text())


def mix(here: pathlib.Path, name: str) -> dict:
    return json.loads((here / "traffic" / f"{_checked(name)}.json")
                      .read_text())


def load_module(path: pathlib.Path, prefix: str):
    """The Python file ``path`` as a module named ``<prefix>.<stem>``."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}.{path.stem.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(here: pathlib.Path, cfg: dict):
    return load_module(here / "entries" / f"{_checked(cfg['entry'])}.py",
                       "benchmark.entries")


def generator(here: pathlib.Path, mix_: dict):
    return load_module(here / "traffic" / f"{_checked(mix_['generator'])}.py",
                       "benchmark.traffic")


def metrics(bench: dict, section: str, cell: str) -> list[dict]:
    """The ``section`` ('end_to_end' or 'per_layer') metrics this cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def readers(here: pathlib.Path, bench: dict, cell: str) -> dict:
    """name -> the module of ``metrics/<name>.py`` for each per-layer
    metric of the cell; each declares NAME, UNIT, LAYER, SOURCE, MOVES and
    ``read(trace)``, which returns a number or None."""
    out = {}
    for m in metrics(bench, "per_layer", cell):
        mod = load_module(here / "metrics" / f"{_checked(m['name'])}.py",
                          "benchmark.metrics")
        if mod.NAME != m["name"] or mod.UNIT != m["unit"]:
            raise ValueError(f"metrics/{m['name']}.py declares {mod.NAME!r} "
                             f"in {mod.UNIT!r}, BENCHMARK.json "
                             f"{m['name']!r} in {m['unit']!r}")
        out[m["name"]] = mod
    return out
