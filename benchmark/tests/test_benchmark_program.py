"""The program's spans and counters as the benchmark reads them: the six
readers of benchmark/program.py's summary, the trace reduction unchanged by
the program's new ranges, and a traced CPU run that reports them (its
program stretch in a process of its own) where an untraced run does not."""

import pathlib
import time
import types

import pytest

from benchmark import cell, trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = cell.load_benchmark(ROOT)
NEW = ("back_half_span_ms_per_frame", "back_half_attempt_ms_per_frame",
       "back_half_update_ms_per_frame", "back_half_scans_per_frame",
       "host_reads_per_frame", "upload_ms_per_frame")
OFFLINE, FLEET = "offline-demo1.motion-drop", "fleet16-demo1.motion-clean"


def summary():
    """A canned stretch of 512 frames: two scans, two host reads."""
    def row(n, total_ms, self_ms):
        return {"n": n, "total_ns": int(total_ms * 1e6),
                "self_ns": int(self_ms * 1e6)}

    return {"spans": {"lt.chunk": row(1, 10240.0, 1.0),
                      "lt.upload": row(1, 256.0, 256.0),
                      "lt.back_half": row(2, 7680.0, 512.0),
                      "lt.back_half.attempt": row(1536, 5120.0, 5120.0),
                      "lt.back_half.update": row(1024, 2048.0, 2048.0),
                      "lt.host_read": row(2, 0.5, 0.5)},
            "counters": {"lt.frames": 512, "lt.back_half.frames": 1024,
                         "lt.host_reads": 2, "lt.rescans": 1},
            "units": 1}


def read_all(program, name=OFFLINE):
    reading = types.SimpleNamespace(program=program)
    mods = cell.readers(HERE, BENCH, name)
    return {n: mods[n].read(reading) for n in NEW if n in mods}


def test_readers_on_a_canned_summary():
    got = read_all(summary())
    assert got == {"back_half_span_ms_per_frame": pytest.approx(15.0),
                   "back_half_attempt_ms_per_frame": pytest.approx(10.0),
                   "back_half_update_ms_per_frame": pytest.approx(4.0),
                   "back_half_scans_per_frame": 2.0,
                   "host_reads_per_frame": 2 / 512,
                   "upload_ms_per_frame": pytest.approx(0.5)}
    assert "upload_ms_per_frame" not in read_all(summary(), FLEET)


def test_readers_without_a_program_stretch_return_nothing():
    """An older program (no ``recording``) or a run outside run_cell."""
    assert set(read_all(None).values()) == {None}
    bare = trace.TraceReading([], 2, 1.0, {})
    mods = cell.readers(HERE, BENCH, OFFLINE)
    assert all(mods[n].read(bare) is None for n in NEW)


def test_counters_that_never_counted_read_zero():
    s = summary()
    del s["counters"]["lt.host_reads"]
    assert read_all(s)["host_reads_per_frame"] == 0.0


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts, name, k_ts, dur, cat="kernel"):
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
             "dur": 2, "args": {"correlation": corr}},
            {"cat": cat, "name": name, "ts": k_ts, "dur": dur,
             "args": {"correlation": corr}}]


def _stages():
    """test_benchmark_trace.py's two frames: the stage ranges and their
    launches, one launch outside every range."""
    ev = [_span("lt.warp_lab", 0, 100), _span("lt.filter", 100, 100),
          _span("lt.embed_search", 200, 100),
          _span("lt.second_attempt", 300, 50),
          _span("lt.back_half", 350, 300), _span("lt.overlay", 650, 50)]
    for corr, (ts, name, k_ts, dur) in enumerate([
            (10, "gather", 20, 40), (110, "tophat_kernel", 120, 30),
            (210, "cumsum", 220, 5), (310, "adaptive_mean_kernel", 315, 20),
            (400, "where", 420, 10), (455, "fit", 470, 10),
            (610, "stack", 612, 5), (660, "overlay", 670, 20),
            (720, "late", 725, 5)]):
        ev += _launch(corr, ts, name, k_ts, dur)
    return ev


def _with_program_ranges(events):
    """The same events with the root span around them, the upload before
    the warp and the back half's parts and host read nested in it."""
    return [_span("lt.chunk", -40, 780), _span("lt.upload", -30, 25)] + (
        events + [_span("lt.back_half.attempt", 352, 90),
                  _span("lt.back_half.attempt", 450, 60),
                  _span("lt.back_half.update", 512, 90),
                  _span("lt.back_half.stack", 605, 20),
                  _span("lt.host_read", 630, 15)])


def test_stage_table_and_breakdown_ignore_the_program_ranges():
    plain, nested = _stages(), _with_program_ranges(_stages())
    assert trace.stage_table(nested) == trace.stage_table(plain)
    assert trace.breakdown(nested, 0, 730) == trace.breakdown(plain, 0, 730)
    assert trace.stage_table(plain)["lt.back_half"]["launches"] == 3


def _small_run(name, traced):
    """run_cell on the CPU: two-frame chunks (two streams of two frames in
    the fleet) over a pool of two frames, motion-drop's second black, so
    that every offline chunk, the program stretch's too, rescans.  Host
    reads: two a chunk offline (two_phase's, ``process_chunk``'s), two a
    fleet step (the shard's two_phase read, ``auto``'s)."""
    import torch

    from benchmark import harness

    torch.set_num_threads(4)
    return harness.run_cell(
        ROOT, BENCH, name, 2**31 + 11, 0.05, traced, torch.device("cpu"),
        time.perf_counter(),
        config_override={"chunk_frames": 2, "streams": 2,
                         "warm_up_units": 1, "trace_units": 1},
        mix_override={"pool_frames": 2,
                      "dropouts": [[1, 1]] if "drop" in name else []})


@pytest.mark.parametrize("name", [OFFLINE, FLEET])
def test_a_traced_cpu_run_reports_the_program_metrics(name):
    want = {n for n in NEW if n in cell.readers(HERE, BENCH, name)}
    traced = _small_run(name, traced=True)
    got = traced["result"]["metrics"]
    assert want <= set(got)
    assert got["back_half_scans_per_frame"] == {
        "value": 2.0 if name == OFFLINE else 1.0, "unit": "scans/frame"}
    assert got["host_reads_per_frame"]["value"] == pytest.approx(
        1.0 if name == OFFLINE else 0.5)
    assert traced["result"]["correct"], traced["lines"]
    window = _small_run(name, traced=False)
    assert not set(NEW) & set(window["result"]["metrics"])
