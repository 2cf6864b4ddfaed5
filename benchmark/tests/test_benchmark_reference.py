"""The reference agrees with the port on the CPU, the control does not,
and each fault the cells can have turns ``correct`` false."""

import pathlib

import numpy as np
import pytest
import torch

from benchmark import check, reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("offline-demo1.motion-drop", "fleet16-demo1.motion-clean")


def test_reference_equals_the_port_on_two_chunks():
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
        warp.mpph, pipeline="fast", device="cpu")
    cfg = PRESETS["demo1"]
    scenes = load_scenes("cpu")
    frames = torch.stack([motion_frame(t, scenes) for t in (148, 149, 150)])
    frames[1] = 0
    st = make_initial_state(cfg, params.warped_size, "cpu")
    rparams = reference.build_params(ROOT / "assets" / "calibration.npz",
                                     "fast", "cpu")
    import json

    settings = json.loads((ROOT / "benchmark" / "configs"
                           / "offline-demo1.json").read_text())["tracker"]
    rcfg = reference.tracker_config(settings)
    rstate = reference.initial_state(rcfg, rparams, "cpu")
    for chunk in (frames[:2], frames[2:]):
        st, outs = chunk_process(st, chunk, params, cfg,
                                 second_attempt="two_phase")
        rstate, routs = reference.run_chunk(rstate, chunk, rparams, rcfg)
        for k, v in outs._asdict().items():
            if v is not None:
                assert np.array_equal(v.numpy(), routs[k]), k
        for k, v in st._asdict().items():
            assert np.array_equal(v.numpy(), rstate[k]), k


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_run, name):
    out = small_run(name)
    assert out["result"]["correct"], out["lines"]
    assert list(out["result"])[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(small_run, name):
    out = small_run(name, control="bfloat16")
    assert not out["result"]["correct"], out["lines"]


def _fault(monkeypatch, name, kind):
    """Break the timed path underneath the harness."""
    from lane_tracker_tpu_torch.parallel.streams import StreamFleet
    from lane_tracker_tpu_torch.tracker.tracker import LaneTracker

    if name.startswith("offline"):
        orig = LaneTracker.process_chunk

        def process_chunk(self, frames, *a, **kw):
            if kind == "half":
                # half of the batch left out: the answers of the first half
                # stand for the rest
                half = max(1, len(frames) // 2)
                outs = orig(self, frames[:half], *a, **kw)
                idx = torch.arange(len(frames)) % half
                return type(outs)(*(None if x is None else x[idx]
                                    for x in outs))
            before = self._state
            outs = orig(self, frames, *a, **kw)
            if kind == "state" and before is not None:
                self._state = before  # the state comes back unchanged
            if kind == "answer":
                outs.valid[-1] = ~outs.valid[-1]  # an answer altered
            return outs

        monkeypatch.setattr(LaneTracker, "process_chunk", process_chunk)
    else:
        orig = StreamFleet.step

        def step(self, frames):
            before = self.states
            if kind == "half":
                S = frames.shape[0]
                outs, m = orig(self, frames)
                idx = torch.arange(S) % max(1, S // 2)
                return type(outs)(*(None if x is None else x[idx]
                                    for x in outs)), m
            outs, m = orig(self, frames)
            if kind == "state":
                self.states = before
            if kind == "answer":
                outs.valid[0, -1] = ~outs.valid[0, -1]
            return outs, m

        monkeypatch.setattr(StreamFleet, "step", step)


@pytest.mark.parametrize("kind", ["state", "half", "answer"])
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_turns_correct_false(small_run, monkeypatch, name, kind):
    _fault(monkeypatch, name, kind)
    out = small_run(name)
    assert not out["result"]["correct"], (kind, out["lines"])


def test_judge():
    ok, table = check.judge({"decisions": 0, "curve_px": 0.001,
                             "radius_rel": 0.0,
                             "overlay_share": float("nan")},
                            {k: 1.0 for k in check.NUMBERS})
    assert not ok and set(table) == set(check.NUMBERS)


def test_curve_gap():
    a = np.array([[1e-4, 0.0, 100.0]])
    b = np.array([[0.0, 0.0, 100.0]])
    assert check.curve_gap(a, b, 11) == pytest.approx(1e-2)
    assert check.curve_gap(a[:0], b[:0], 11) == 0.0
    assert check.curve_gap(a * np.nan, b, 11) == float("inf")
