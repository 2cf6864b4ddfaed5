"""The 'corridor' configuration and the clean offline cell: the port's
'corridor' equals the reference's on the CPU, ``corridor_ok`` included,
small runs of both cells are correct and the control of the corridor cell
is not, a traced run reports the corridor's two metrics at the corridor's
compute width, and the two readers on canned summaries."""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

from benchmark import cell, reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
BENCH = cell.load_benchmark(ROOT)
CORRIDOR = "offline-corridor-demo1.motion-drop"
CLEAN = "offline-demo1.motion-clean"
READERS = ("corridor_embed_ms_per_frame", "corridor_uncertified_share")


def test_reference_equals_the_port_on_two_chunks_at_corridor():
    """Two two_phase chunks, the first with a black frame (attempt 1 fails
    there, so the rescan and the blind search run): every output field,
    ``corridor_ok`` among them, and the end state, element for element."""
    from lane_tracker_tpu_torch.calib.io import load_calibration_npz
    from lane_tracker_tpu_torch.io.motion import load_scenes, motion_frame
    from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
    from lane_tracker_tpu_torch.tracker.config import PRESETS
    from lane_tracker_tpu_torch.tracker.step import (
        TrackerParams,
        make_initial_state,
    )

    cam, warp = load_calibration_npz(ROOT / "assets" / "calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor", device="cpu")
    assert params.col_roi == (320, 832) and params.col_comp == (240, 912)
    cfg = PRESETS["demo1"]
    scenes = load_scenes("cpu")
    frames = torch.stack([motion_frame(t, scenes) for t in (148, 149, 150)])
    frames[1] = 0
    st = make_initial_state(cfg, params.warped_size, "cpu")
    rparams = reference.build_params(ROOT / "assets" / "calibration.npz",
                                     "corridor", "cpu")
    settings = json.loads((HERE / "configs" / "offline-corridor-demo1.json")
                          .read_text())["tracker"]
    rcfg = reference.tracker_config(settings)
    rstate = reference.initial_state(rcfg, rparams, "cpu")
    for chunk in (frames[:2], frames[2:]):
        st, outs = chunk_process(st, chunk, params, cfg,
                                 second_attempt="two_phase")
        rstate, routs = reference.run_chunk(rstate, chunk, rparams, rcfg)
        for k, v in outs._asdict().items():
            if v is not None:
                assert np.array_equal(v.numpy(), routs[k]), k
        assert "corridor_ok" in routs
        for k, v in st._asdict().items():
            assert np.array_equal(v.numpy(), rstate[k]), k


@pytest.mark.parametrize("name", [CORRIDOR, CLEAN])
def test_a_sound_run_of_a_new_cell_is_correct(small_run, name):
    out = small_run(name)
    assert out["result"]["correct"], out["lines"]


def test_the_control_of_the_corridor_cell_is_not_correct(small_run):
    out = small_run(CORRIDOR, control="bfloat16")
    assert not out["result"]["correct"], out["lines"]


def test_a_traced_cpu_run_reports_the_corridor_metrics(small_run,
                                                       monkeypatch):
    """The program stretch (a process of its own) opens the embed span and
    counts the corridor's frames; the roofline readers get the corridor's
    compute width, 672 of 1080 columns."""
    from benchmark import trace

    shapes = []

    class Reading(trace.TraceReading):
        def __init__(self, events, frames, window_s, shapes_):
            shapes.append(shapes_)
            super().__init__(events, frames, window_s, shapes_)

    monkeypatch.setattr(trace, "TraceReading", Reading)
    out = small_run(CORRIDOR, traced=True)
    got = out["result"]["metrics"]
    assert got["corridor_embed_ms_per_frame"]["value"] > 0
    assert 0 <= got["corridor_uncertified_share"]["value"] <= 1
    assert got["back_half_scans_per_frame"]["value"] >= 1.0
    assert [s["W"] for s in shapes] == [672]
    assert out["result"]["correct"], out["lines"]


def _summary(counters):
    return {"spans": {"lt.chunk": {"n": 1, "total_ns": 10**9,
                                   "self_ns": 10**6},
                      "lt.corridor.embed": {"n": 3, "total_ns": 256 * 10**6,
                                            "self_ns": 256 * 10**6}},
            "counters": counters, "units": 1}


def _read(summary, name=CORRIDOR):
    reading = types.SimpleNamespace(program=summary)
    mods = cell.readers(HERE, BENCH, name)
    return {n: mods[n].read(reading) for n in READERS if n in mods}


@pytest.mark.parametrize("counters, share", [
    ({"lt.frames": 512, "lt.corridor.frames": 512,
      "lt.corridor.uncertified": 128}, 0.25),
    ({"lt.frames": 512, "lt.corridor.frames": 512}, 0.0),
    ({"lt.frames": 512}, None),
])
def test_corridor_readers_on_a_canned_summary(counters, share):
    """A stretch of 512 frames, 256 ms of embedding: 0.5 ms a frame.  An
    uncertified counter that never counted reads 0; a program that counts
    no corridor frames (another pipeline, or a program without the
    counter) gives no share."""
    got = _read(_summary(counters))
    assert got["corridor_embed_ms_per_frame"] == pytest.approx(0.5)
    assert got["corridor_uncertified_share"] == share


def test_corridor_readers_without_a_stretch_or_a_span():
    assert set(_read(None).values()) == {None}
    s = _summary({"lt.frames": 512})
    del s["spans"]["lt.corridor.embed"]
    assert _read(s)["corridor_embed_ms_per_frame"] is None


def test_corridor_metrics_are_read_in_the_corridor_cell_only():
    for name in [w["name"] for w in BENCH["workloads"] if w["name"]
                 != CORRIDOR]:
        assert not set(READERS) & set(cell.readers(HERE, BENCH, name))
    assert "second_attempt_host_ms_per_frame" not in cell.readers(
        HERE, BENCH, CLEAN)
