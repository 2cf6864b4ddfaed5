"""No module of the harness or the reference has the top-level name
``jax`` or ``lane_tracker_tpu`` (compared whole), and the reference
imports nothing of the port; the command refuses to run without a card
and in a directory without the program."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "lane_tracker_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, time, torch\nsys.path.insert(0, '.')\n"
            "from benchmark import harness, cell, control, roofline, trace\n"
            "from benchmark.tests.conftest import SMALL_CONFIG, small_mix\n"
            "b = cell.load_benchmark(harness.ROOT)\n"
            "for n in ('offline-demo1.motion-drop',):\n"
            "    harness.run_cell(harness.ROOT, b, n, 5, 0.01, True,\n"
            "        torch.device('cpu'), time.perf_counter(),\n"
            "        config_override=SMALL_CONFIG, mix_override=small_mix(n))\n")
    found = _modules(code)
    assert "lane_tracker_tpu_torch" in found
    assert not found & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    found = _modules("import sys\nsys.path.insert(0, '.')\n"
                     "import benchmark.reference, benchmark.check\n"
                     "import benchmark.traffic.motion, benchmark.roofline")
    assert not found & (FORBIDDEN | {"lane_tracker_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    from benchmark import harness

    sys.modules.setdefault("jaxtyping_stub_for_test", sys)
    try:
        assert "jaxtyping_stub_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["jaxtyping_stub_for_test"]


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "offline-demo1.motion-drop", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "offline-demo1.motion-drop", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """One short run of each cell on the card: a result, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name in ("offline-demo1.motion-drop", "fleet16-demo1.motion-clean"):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", name,
             "--seed", "123456789012", "--seconds", "1", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
