"""The port's LaneTracker against the JAX package's, at full size.

Both packages' ``LaneTracker`` are built from assets/calibration.npz with
demo1's validity and run ``process`` with the same keyword arguments
(``DEMO1_KW`` of tests/test_tracker.py, ``mask_noise=True``) on the same
frames from a fresh state, in 'compat' and in 'fast': the four stills
(assets/stills_720p.npz), a black frame (both attempts fail) and the
first still again, so that sliding-window search, band search, the second
attempt and the failure path all run.  JAX runs on the CPU on its XLA filter
chain; the port on the CPU (``device="cpu"``), where its kernel wrappers
run their plain versions.  Every frame is processed with
``diagnostics=True``; frame 0 and frame 5 also with ``visualize_search``
(sliding window, band) and frame 2 with ``split_view``.

Tolerances:

* per frame, the decision fields (validity, detection, search mode,
  attempts, point counts, render mode) and the radius are identical, the
  coefficients within 0.01 px curve RMSE;
* the annotated frames within 1 unit (the count is printed), and the
  pixels the text was drawn on equal (``draw_text`` is a host copy);
* ``get_success_ratio`` and the diagnostics transcript, line for line,
  equal;
* a snapshot written by either package's ``save_state`` and loaded by the
  other's ``load_state`` continues to the same next frame;
* the port's ``process_chunk`` over the frames equals its ``process``,
  exactly, every field;
* ``visualize_search`` and ``split_view``: the search picture equals
  JAX's exactly, and the split view's warped pane (the raw frame through
  the full-frame warp grid) within 1 unit on at most
  ``WARP_PANE_MAX_SHARE`` of its values.  JAX's split view calls
  ``bilinear_gather`` outside jit, where XLA does not contract the float
  combine into fused multiply-adds, so each of its tap products rounds to
  float32 apart; the port's gather forms the fused chain its tracker
  program does.  The two roundings differ by at most one unit after
  ``rint``, and on few pixels (the reference's own warp contract, <= 1 unit
  on < 0.05% of pixels, README.md "Parity with the reference").
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tests.conftest import ASSETS_DIR
from tests.test_torch_pipeline import curve_rmse, port_config

from lane_tracker_tpu.calib.io import load_calibration_npz as j_load
from lane_tracker_tpu.tracker.config import PRESETS as J_PRESETS
from lane_tracker_tpu.tracker.tracker import LaneTracker as JTracker

import lane_tracker_tpu_torch as lt
from lane_tracker_tpu_torch.tracker.tracker import LaneTracker as TTracker

DEMO1_KW = dict(
    ksize_r=15, C_r=8, ksize_b=35, C_b=5, filter_type="bilateral",
    mask_noise=True, noise_thresh=140, ksize_noise=65, C_noise=10,
    window_width=30, window_height=40, search_range=20, mu=0.1,
    no_success_limit=50, start_slice=0.25, ignore_sides=360,
    ignore_bottom=30, bandwidth=30, partial=1.0, n_tries=2,
)
# Stills 0-3, a black frame, still 0 again.
SCHEDULE = (0, 1, 2, 3, "black", 0)
FLAGS = {0: dict(visualize_search=True), 2: dict(split_view=True),
         5: dict(visualize_search=True)}
SNAPSHOT_AT = 2  # the snapshot is written after frame 2 and read for frame 3
DECISIONS = ("valid", "detected", "search_mode", "n_attempts",
             "n_points_left", "n_points_right", "render_mode", "radius",
             "a1_valid", "a1_detected", "a1_n_left", "a1_n_right")
WARP_PANE_MAX_SHARE = 0.0005
H = 1100


def frames():
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        stills = z["frames"]
    return np.stack([np.zeros_like(stills[0]) if i == "black" else stills[i]
                     for i in SCHEDULE])


def make_tracker(cls, pipeline, **device):
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    validity = J_PRESETS["demo1"].validity
    if cls is TTracker:
        validity = port_config(J_PRESETS["demo1"]).validity
    return cls(warp.image_width_height, warp.warped_width_height,
               cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
               (warp.mppv, warp.mpph), validity=validity, pipeline=pipeline,
               **device)


def host_output(out) -> dict:
    return {k: None if v is None else (v.numpy() if isinstance(v, torch.Tensor)
                                       else np.asarray(v))
            for k, v in out._asdict().items()}


def drive(tracker, fs, tmp_path, tag):
    """process() over ``fs`` with diagnostics, FLAGS' debug pictures and a
    snapshot after frame SNAPSHOT_AT: per-frame results, the transcript
    lines and the snapshot's path."""
    rec = dict(annotated=[], outputs=[], lines=[], pictures={})
    snapshot = tmp_path / f"{tag}.npz"
    for i, f in enumerate(fs):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = tracker.process(f, diagnostics=True, **FLAGS.get(i, {}),
                                  **DEMO1_KW)
        rec["lines"].append(buf.getvalue().splitlines())
        if "visualize_search" in FLAGS.get(i, {}):
            res, rec["pictures"][i] = res
        elif "split_view" in FLAGS.get(i, {}):
            rec["pictures"][i] = res
            res = res[:f.shape[0]]
        rec["annotated"].append(np.asarray(res))
        rec["outputs"].append(host_output(tracker.last_output))
        if i == SNAPSHOT_AT:
            tracker.save_state(snapshot)
    rec["ratio"] = tracker.get_success_ratio()
    rec["snapshot"] = snapshot
    return rec


@pytest.fixture(scope="module", params=["compat", "fast"])
def runs(request, tmp_path_factory):
    pipeline = request.param
    tmp = tmp_path_factory.mktemp(pipeline)
    fs = frames()
    j = drive(make_tracker(JTracker, pipeline), fs, tmp, "jax")
    t = drive(make_tracker(TTracker, pipeline, device="cpu"), fs, tmp, "port")
    return pipeline, fs, j, t


def assert_output_matches(jo: dict, to: dict, tag):
    for f in DECISIONS:
        np.testing.assert_array_equal(to[f], jo[f], err_msg=f"{tag} {f}")
    for f in ("left_coeffs", "right_coeffs", "a1_left_coeffs",
              "a1_right_coeffs"):
        assert curve_rmse(to[f], jo[f], H) <= 0.01, f"{tag} {f}"


def test_process_matches_jax(runs):
    pipeline, fs, j, t = runs
    assert [bool(o["valid"]) for o in j["outputs"]] == [
        True, True, True, True, False, True]
    assert [int(o["n_attempts"]) for o in j["outputs"]][4] == 2
    assert {int(o["search_mode"]) for o in j["outputs"]} == {0, 1}
    for i, (jo, to) in enumerate(zip(j["outputs"], t["outputs"])):
        assert_output_matches(jo, to, f"frame {i}")


def test_annotated_frames_match_jax(runs):
    pipeline, fs, j, t = runs
    for i, (ja, ta, jo) in enumerate(zip(j["annotated"], t["annotated"],
                                         j["outputs"])):
        d = np.abs(ta.astype(int) - ja.astype(int))
        print(f"{pipeline} frame {i}: {int((d != 0).sum())} of {d.size} "
              f"values differ")
        assert d.max() <= 1, f"frame {i}"
        # The text: every pixel the annotation changed in either package.
        text = ((ja != jo["overlay"]) | (ta != t["outputs"][i]["overlay"]))
        assert text.any()
        np.testing.assert_array_equal(ta[text], ja[text], err_msg=f"frame {i}")


def test_success_ratio_and_transcript_match_jax(runs):
    _, _, j, t = runs
    assert t["ratio"] == j["ratio"] == (5 / 6, 5, 6)
    for i, (jl, tl) in enumerate(zip(j["lines"], t["lines"])):
        assert tl == jl, f"frame {i}"
    transcript = [line for lines in t["lines"] for line in lines]
    for needed in ("Using sliding window search.", "Using band search.",
                   "No success at first attempt, now trying second.",
                   "No success after all attempts."):
        assert needed in transcript


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_continues_in_the_other_package(runs, direction):
    """A snapshot of frame SNAPSHOT_AT's state, written by one package and
    loaded by the other, continues to that package's own next frame."""
    pipeline, fs, j, t = runs
    writer, reader = (j, t) if direction == "jax_to_port" else (t, j)
    if direction == "jax_to_port":
        tracker = make_tracker(TTracker, pipeline, device="cpu")
    else:
        tracker = make_tracker(JTracker, pipeline)
    tracker.load_state(writer["snapshot"])
    assert (tracker.counter, tracker.success) == (SNAPSHOT_AT + 1,
                                                  SNAPSHOT_AT + 1)
    nxt = SNAPSHOT_AT + 1
    got = np.asarray(tracker.process(fs[nxt], **DEMO1_KW))
    out = host_output(tracker.last_output)
    assert_output_matches(writer["outputs"][nxt], out, direction)
    assert_output_matches(reader["outputs"][nxt], out, direction)
    assert np.abs(got.astype(int)
                  - writer["annotated"][nxt].astype(int)).max() <= 1


def test_process_chunk_equals_process(runs):
    pipeline, fs, _, t = runs
    tracker = make_tracker(TTracker, pipeline, device="cpu")
    outs = tracker.process_chunk(fs, **DEMO1_KW)
    assert tracker.get_success_ratio() == t["ratio"]
    for i, want in enumerate(t["outputs"]):
        for f, w in want.items():
            np.testing.assert_array_equal(getattr(outs, f)[i].numpy(), w,
                                          err_msg=f"frame {i} {f}")
    last = host_output(tracker.last_output)
    for f, w in t["outputs"][-1].items():
        np.testing.assert_array_equal(last[f], w, err_msg=f)


def test_debug_pictures_match_jax(runs):
    pipeline, fs, j, t = runs
    for i in (0, 5):
        jv, tv = j["pictures"][i], t["pictures"][i]
        assert tv.shape == jv.shape == (1100, 1080, 3)
        np.testing.assert_array_equal(tv, jv, err_msg=f"search picture {i}")
        # windows (sliding window) or band, and both sides' pixels drawn
        assert (tv[..., 1] == 127).any() or (tv[..., 1] == 76).any()
        assert ((tv == [255, 0, 0]).all(-1).any()
                and (tv == [0, 0, 255]).all(-1).any())
    js, ts = j["pictures"][2], t["pictures"][2]
    assert ts.shape == js.shape == (720 + 652, 1280, 3)
    np.testing.assert_array_equal(ts[:720], js[:720])
    d = np.abs(ts.astype(int) - js.astype(int))
    n = int((d != 0).sum())
    print(f"{pipeline} split view: {n} of {d.size} values differ, at most "
          f"{d.max()}")
    assert d.max() <= 1 and n <= WARP_PANE_MAX_SHARE * d[720:].size


@pytest.mark.parametrize("option", ["latency_mode", "half", "turbo"])
def test_unported_options_raise(option):
    kw = (dict(latency_mode=True, pipeline="fast") if option == "latency_mode"
          else dict(pipeline=option))
    cam, warp = lt.load_calibration_npz(ASSETS_DIR / "calibration.npz")
    match = "rowmm" if option == "latency_mode" else option
    with pytest.raises(NotImplementedError, match=match):
        TTracker(warp.image_width_height, warp.warped_width_height,
                 cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
                 (warp.mppv, warp.mpph), device="cpu", **kw)


def test_chunk_kwargs_checked_and_reset_forgets_state(runs):
    """``process_chunk`` refuses the per-frame debug flags; ``reset``
    forgets a loaded state; ``save_state`` needs one."""
    pipeline, fs, _, t = runs
    tracker = make_tracker(TTracker, pipeline, device="cpu")
    with pytest.raises(RuntimeError, match="no state"):
        tracker.save_state(t["snapshot"].with_name("unused.npz"))
    with pytest.raises(TypeError, match="diagnostics"):
        tracker.process_chunk(fs[:1], diagnostics=True)
    tracker.load_state(t["snapshot"])
    assert tracker.counter == SNAPSHOT_AT + 1
    tracker.reset()
    assert (tracker.counter, tracker.success, tracker._state) == (0, 0, None)
