"""The trace reduction on a canned trace: the copied ``stage_table``, the
device's busy time, the breakdown and the per-layer readers."""

import pathlib

import pytest

from benchmark import cell, roofline, trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = cell.load_benchmark(ROOT)


def span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def launch(corr, ts):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2, "args": {"correlation": corr}}


def kernel(name, corr, ts, dur, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def canned():
    """Two frames: warp 0-100 us, filter 100-200, embed 200-300, the
    second attempt 300-350, the back half 350-650, the overlay 650-700;
    one launch outside every range."""
    ev = [span("lt.warp_lab", 0, 100), span("lt.filter", 100, 100),
          span("lt.embed_search", 200, 100),
          span("lt.second_attempt", 300, 50), span("lt.back_half", 350, 300),
          span("lt.overlay", 650, 50)]
    ev += [launch(1, 10), kernel("gather", 1, 20, 40),
           launch(2, 110), kernel("void tophat_kernel<1>(...)", 2, 120, 30),
           launch(3, 120), kernel("threshold_kernel", 3, 150, 10),
           launch(4, 210), kernel("cumsum", 4, 220, 5),
           launch(5, 310), kernel("adaptive_mean_kernel", 5, 315, 20),
           launch(6, 400), kernel("where", 6, 420, 10),
           launch(7, 500), kernel("memcpy", 7, 505, 5, cat="gpu_memcpy"),
           launch(8, 660), kernel("overlay", 8, 670, 20),
           launch(9, 720), kernel("late", 9, 725, 5)]
    return ev


def test_stage_table():
    t = trace.stage_table(canned())
    assert t["lt.warp_lab"] == {"host_ms": 0.1, "device_ms": 0.04,
                                "launches": 1}
    assert t["lt.filter"]["device_ms"] == pytest.approx(0.04)
    assert t["lt.filter"]["launches"] == 2
    assert t["lt.second_attempt"]["launches"] == 1
    assert t["lt.back_half"]["host_ms"] == pytest.approx(0.3)
    assert t["lt.back_half"]["launches"] == 2
    assert t["lt.back_half"]["device_ms"] == pytest.approx(0.015)
    assert t["(outside)"]["launches"] == 1
    halves = trace.stage_table(canned(), reps=2)
    assert halves["lt.back_half"]["launches"] == 1


def test_busy_union_and_hand_kernels():
    ev = canned() + [kernel("overlap", 10, 30, 40)]  # 30-70 over 20-60
    assert trace.busy_seconds(ev) == pytest.approx((50 + 30 + 10 + 5 + 20
                                                    + 10 + 5 + 20 + 5)
                                                   / 1e6)
    names = sorted(trace.hand_kernel_name(e)
                   for e in trace.hand_kernel_events(ev))
    assert names == ["adaptive_mean_kernel", "threshold_kernel",
                     "tophat_kernel"]


def test_breakdown():
    b = trace.breakdown(canned(), 0, 730)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0] == ["gather", pytest.approx(40e-6)]
    gaps = dict(b["idle_gaps"])
    # a gap goes to the range open where it starts
    assert gaps["lt.back_half"] == pytest.approx((505 - 430 + 670 - 510)
                                                 / 1e6)
    assert gaps["lt.second_attempt"] == pytest.approx((420 - 335) / 1e6)
    busy = trace.busy_seconds(canned())
    assert sum(gaps.values()) == pytest.approx(730e-6 - busy)


def reading(events=None, frames=2, window_s=730e-6):
    shapes = {"frames_per_call": 2, "H": 1100, "W": 1080, "raw_rows": 400,
              "raw_width": 1280,
              "filter": {"mask_noise": True, "tophat_r": 29, "tophat_b": 55,
                         "open_k": 5}, "second_open_k": 5}
    return trace.TraceReading(canned() if events is None else events,
                              frames, window_s, shapes)


def readers(name):
    return cell.readers(HERE, BENCH, name)


def test_readers_on_the_canned_trace():
    r = reading()
    got = {n: m.read(r) for n, m in readers(
        "offline-demo1.motion-drop").items()}
    assert got["warp_lab_device_ms_per_frame"] == pytest.approx(0.02)
    assert got["filter_device_ms_per_frame"] == pytest.approx(0.02)
    assert got["embed_search_host_ms_per_frame"] == pytest.approx(0.05)
    assert got["second_attempt_host_ms_per_frame"] == pytest.approx(0.025)
    assert got["back_half_launches_per_frame"] == 1
    assert got["back_half_host_ms_per_frame"] == pytest.approx(0.15)
    assert got["overlay_device_ms_per_frame"] == pytest.approx(0.01)
    busy = trace.busy_seconds(canned())
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - busy / 730e-6))
    least = roofline.warp_lab_s(2, 400, 1280, 1100, 1080)
    assert got["warp_lab_roofline_pct"] == pytest.approx(
        100 * least / 40e-6)
    least_f = (0.5 * roofline.attempt1_filter_s(2, 1100, 1080, r.shapes[
        "filter"]) + 0.5 * roofline.second_filter_s(2, 1100, 1080, 5))
    assert got["filter_kernels_roofline_pct"] == pytest.approx(
        100 * least_f / 60e-6)


def test_a_reader_with_nothing_to_read_returns_nothing():
    ev = [e for e in canned() if e.get("name") != "lt.second_attempt"
          and "kernel" not in e.get("name", "") and e["cat"] != "kernel"]
    r = reading(ev)
    mods = readers("offline-demo1.motion-drop")
    assert mods["second_attempt_host_ms_per_frame"].read(r) is None
    assert mods["filter_kernels_roofline_pct"].read(r) is None
    assert mods["warp_lab_roofline_pct"].read(r) is None


def test_second_attempt_is_read_only_where_it_runs():
    assert "second_attempt_host_ms_per_frame" not in readers(
        "fleet16-demo1.motion-clean")


@pytest.mark.parametrize("k", [5, 29, 55])
def test_morph_ops_counts(k):
    """The ops of an erode never exceed a row of the ellipse a pixel."""
    assert 1 <= roofline.morph_ops(k) <= 2 * k
    assert roofline.tophat_ops(k) == 2 * roofline.morph_ops(k) + 1


def test_least_times_grow_with_the_work():
    f = {"mask_noise": True, "tophat_r": 29, "tophat_b": 55, "open_k": 5}
    a = roofline.attempt1_filter_s(512, 1100, 1080, f)
    assert roofline.attempt1_filter_s(1024, 1100, 1080, f) == (
        pytest.approx(2 * a))
    assert a > roofline.second_filter_s(512, 1100, 1080, 5) > 0
