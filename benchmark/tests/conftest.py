"""Shared helpers of the benchmark's tests: small CPU runs of a cell."""

import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Two-frame chunks (two streams of two frames in the fleet) over pools of
# four frames, a dropout in the second frame of motion-drop's pool.
SMALL_CONFIG = {"chunk_frames": 2, "streams": 2, "warm_up_units": 1,
                "trace_units": 1}


def small_mix(cell: str) -> dict:
    return {"pool_frames": 4,
            "dropouts": [[1, 1]] if "drop" in cell else []}


@pytest.fixture
def small_run():
    """run(cell, traced=False, control=None, seed=...) -> run_cell's dict,
    on the CPU at the small size."""
    import torch

    from benchmark import cell, harness

    torch.set_num_threads(4)
    bench = cell.load_benchmark(ROOT)

    def run(name, traced=False, control=None, seed=2**31 + 7):
        return harness.run_cell(ROOT, bench, name, seed, 0.05, traced,
                                torch.device("cpu"), time.perf_counter(),
                                control=control, config_override=SMALL_CONFIG,
                                mix_override=small_mix(name))

    return run
