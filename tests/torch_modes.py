"""Shared checks of the port's opt-in pipelines against the JAX package.

tests/test_torch_turbo.py and tests/test_torch_half.py hold 'turbo' and
'half' to the JAX package with these helpers, at full size on the CPU
(assets/calibration.npz, the decoded stills of assets/stills_720p.npz,
demo1, halved by ``halve_config`` for 'half' as ``LaneTracker`` does).
JAX runs its XLA filter chain; the port its kernels' plain versions
(``device="cpu"``).  Each file's work runs in module fixtures, so that
each JAX program compiles once a file.

Tolerances, the port's fit contract: decisions and integer state
identical, coefficient curves within 0.01 px RMSE, overlays within 1
unit; warped R bit-exact, warped LAB-B bit-exact or within the
reference's warp contract (at most 1 unit on under 0.05% of values).
"""

import numpy as np
import torch

import jax

from tests.conftest import ASSETS_DIR
from tests.test_torch_pipeline import (
    DECISIONS,
    INT_STATE,
    curve_rmse,
    port_config,
)
from tests.test_torch_tracker import (
    DEMO1_KW,
    SNAPSHOT_AT,
    assert_output_matches,
    drive,
    frames as schedule_frames,
    host_output,
    make_tracker,
)

from lane_tracker_tpu.calib.io import load_calibration_npz as j_load
from lane_tracker_tpu.parallel.pipeline import chunk_process as j_chunk
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS, halve_config
from lane_tracker_tpu.tracker.tracker import LaneTracker as JTracker

from lane_tracker_tpu_torch.parallel.pipeline import chunk_process as t_chunk
from lane_tracker_tpu_torch.parallel.streams import StreamFleet
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.tracker import LaneTracker as TTracker

T_CHUNK = 8
BLACK = 3  # the chunk's black frame: both attempts fail on it
WARP_MAX_SHARE = 0.0005
CPU2 = ("cpu", "cpu")


def calib_args():
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    return (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)


def build_both(pipeline):
    """(JAX params, the port's params on the CPU) of ``pipeline``."""
    args = calib_args()
    return (j_step.TrackerParams.build(*args, pipeline=pipeline),
            t_step.TrackerParams.build(*args, pipeline=pipeline,
                                       device="cpu"))


def configs(pipeline):
    """(JAX config, the port's): demo1, halved for 'half'."""
    cfg = PRESETS["demo1"]
    if pipeline == "half":
        cfg = halve_config(cfg)
    return cfg, port_config(cfg)


def stills():
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        return z["frames"]


def chunk_frames():
    """The four stills cycled to T_CHUNK frames, frame BLACK black."""
    st = stills()
    frames = st[np.arange(T_CHUNK) % len(st)].copy()
    frames[BLACK] = 0
    return frames


def assert_warp_contract(tag, want, got):
    """LAB-B: bit-exact or at most 1 unit on under WARP_MAX_SHARE of the
    values (the count is printed)."""
    d = np.abs(np.asarray(want).astype(int) - np.asarray(got).astype(int))
    n = int((d != 0).sum())
    print(f"{tag}: {n} of {d.size} values differ, max {d.max()}")
    assert d.max() <= 1 and n < WARP_MAX_SHARE * d.size, (tag, n)


def assert_warp_channels_match(jp, tp, frames):
    """warp_channels of ``frames`` against JAX's ``_warp_channels_batch``:
    R bit-exact, LAB-B within the warp contract."""
    jr, jb = jax.jit(lambda f, p: j_step._warp_channels_batch(f, p))(
        frames, jp)
    tr, tb = t_step.warp_channels(torch.from_numpy(frames), tp)
    assert tuple(tr.shape) == tuple(tb.shape) == tuple(jr.shape)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert_warp_contract(f"{tp.pipeline} LAB-B", jb, tb.numpy())
    return tr, tb


def run_chunks(pipeline, mode="two_phase"):
    """JAX's and the port's ``chunk_process`` on ``chunk_frames()`` from a
    fresh state, overlay on: ((j_state, j_out), (t_state, t_out))."""
    jp, tp = build_both(pipeline)
    jcfg, tcfg = configs(pipeline)
    frames = chunk_frames()
    j = jax.jit(lambda s, f, p: j_chunk(s, f, p, jcfg, True,
                                        second_attempt=mode))(
        j_step.make_initial_state(jcfg, jp.warped_size), frames, jp)
    t = t_chunk(t_step.make_initial_state(tcfg, tp.warped_size, "cpu"),
                torch.from_numpy(frames), tp, tcfg, second_attempt=mode)
    return j, t


def assert_chunks_match(j, t, H):
    (j_state, jo), (t_state, to) = j, t
    assert not np.asarray(jo.a1_valid)[BLACK]
    assert np.asarray(jo.valid).sum() >= T_CHUNK - 2
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    for side in ("left_coeffs", "right_coeffs", "a1_left_coeffs",
                 "a1_right_coeffs"):
        for a, b in zip(getattr(to, side).numpy(),
                        np.asarray(getattr(jo, side))):
            assert curve_rmse(a, b, H) <= 0.01, side
    for f in INT_STATE:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)),
                                      err_msg=f)
    d = np.abs(to.overlay.numpy().astype(int)
               - np.asarray(jo.overlay).astype(int))
    print(f"overlay: {int((d != 0).sum())} of {d.size} values differ")
    assert d.max() <= 1


def assert_fleet_equals_chunks(tp, tcfg, frames):
    """A two-stream fleet over two CPU devices ('two_phase', overlay on):
    each stream equals ``chunk_process`` ('hoist', fresh state) on its
    frames, decisions identical, curves within 0.01 px, overlays within
    1 unit.  ``frames``: (2, T, Hc, Wc, 3)."""
    fleet = StreamFleet(tp, tcfg, 2, mesh=CPU2, with_overlay=True)
    outs, metrics = fleet.step(frames)
    H = tp.warped_size[1]
    assert int(metrics["frames"]) == frames.shape[0] * frames.shape[1]
    for s in range(frames.shape[0]):
        fresh = t_step.make_initial_state(tcfg, tp.warped_size, "cpu")
        _, want = t_chunk(fresh, torch.from_numpy(frames[s]), tp, tcfg,
                          second_attempt="hoist")
        for f in DECISIONS:
            assert torch.equal(getattr(outs, f)[s], getattr(want, f)), (s, f)
        for side in ("left_coeffs", "right_coeffs"):
            for a, b in zip(getattr(outs, side)[s].numpy(),
                            getattr(want, side).numpy()):
                assert curve_rmse(a, b, H) <= 0.01, (s, side)
        d = (outs.overlay[s].int() - want.overlay.int()).abs()
        assert int(d.max()) <= 1, s


def drive_both(pipeline, tmp):
    """Both packages' ``LaneTracker.process`` over tests/test_torch_tracker.
    py's schedule with its debug flags and snapshot: (frames, JAX's record,
    the port's record)."""
    fs = schedule_frames()
    j = drive(make_tracker(JTracker, pipeline), fs, tmp, "jax")
    t = drive(make_tracker(TTracker, pipeline, device="cpu"), fs, tmp, "port")
    return fs, j, t


def assert_process_matches(j, t):
    """Per frame the decisions, the curves and the annotated frame (within
    1); the success ratio and the diagnostics transcript equal."""
    assert t["ratio"] == j["ratio"]
    for i, (jo, to) in enumerate(zip(j["outputs"], t["outputs"])):
        assert_output_matches(jo, to, f"frame {i}")
        d = np.abs(t["annotated"][i].astype(int)
                   - j["annotated"][i].astype(int))
        assert d.max() <= 1, i
    assert t["lines"] == j["lines"]


def assert_snapshot_continues(pipeline, drives, direction):
    """A snapshot written by one package and loaded by the other continues
    to the writer's next frame."""
    fs, j, t = drives
    writer, cls, kw = ((j, TTracker, dict(device="cpu"))
                       if direction == "jax_to_port" else (t, JTracker, {}))
    tracker = make_tracker(cls, pipeline, **kw)
    tracker.load_state(writer["snapshot"])
    nxt = SNAPSHOT_AT + 1
    tracker.process(fs[nxt], **DEMO1_KW)
    assert_output_matches(writer["outputs"][nxt],
                          host_output(tracker.last_output), direction)
