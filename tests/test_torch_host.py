"""The port's host-side copies and params equal the JAX package's, exactly.

lane_tracker_tpu_torch cannot import lane_tracker_tpu (its __init__ loads
jax), so the pure-numpy helpers are copies; these tests pin every copy,
the built TrackerParams, the state conversion and the committed decoded
stills to the originals.  Tolerance: exact equality everywhere.  The
port's entry points default to the card: tests here pass ``device="cpu"``,
and one test shows the default raising where CUDA is absent.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from tests.conftest import ASSETS_DIR

import lane_tracker_tpu.calib.homography as j_hom
import lane_tracker_tpu.calib.undistort as j_und
import lane_tracker_tpu.tracker.config as j_cfg
from lane_tracker_tpu.calib.io import load_calibration_npz as j_load
from lane_tracker_tpu.calib.synthetic import make_synthetic_calibration
from lane_tracker_tpu.kernels.resample import ResampleGrid as JGrid
from lane_tracker_tpu.ops.morphology import ellipse_runs as j_runs
from lane_tracker_tpu.render.lane import forward_bv_grid as j_fwd
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.state import init_state as j_init_state
from lane_tracker_tpu.tracker.state import state_from_npz as j_state_from_npz
from lane_tracker_tpu.tracker.state import state_to_npz as j_state_to_npz

import lane_tracker_tpu_torch.calib.homography as t_hom
import lane_tracker_tpu_torch.calib.undistort as t_und
import lane_tracker_tpu_torch.tracker.config as t_cfg
from lane_tracker_tpu_torch.calib.io import load_calibration_npz as t_load
from lane_tracker_tpu_torch.kernels.resample import slot_remap
from lane_tracker_tpu_torch.kernels.resample_mxu2 import MxuWarp2
from lane_tracker_tpu_torch.ops.morphology import ellipse_runs as t_runs
from lane_tracker_tpu_torch.render.lane import forward_bv_grid as t_fwd
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.state import init_state, state_from_numpy
from lane_tracker_tpu_torch.tracker.state import (
    state_from_npz as t_state_from_npz,
)
from lane_tracker_tpu_torch.tracker.state import (
    state_to_npz as t_state_to_npz,
)
from lane_tracker_tpu_torch.tracker.tracker import LaneTracker as TTracker

REPO = pathlib.Path(__file__).resolve().parent.parent
STILLS = ["frame911.jpg", "frame971.jpg", "test4.jpg", "straight_lines1.jpg"]


def _calibrations():
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    yield cam, warp
    yield make_synthetic_calibration(img_size=(128, 96), warped_size=(96, 128))


def _assert_grid_dicts_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if k == "src_size":
            assert tuple(a[k]) == tuple(b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_calibration_loader_copy():
    (jc, jw), (tc, tw) = (j_load(ASSETS_DIR / "calibration.npz"),
                          t_load(ASSETS_DIR / "calibration.npz"))
    np.testing.assert_array_equal(jc.cam_matrix, tc.cam_matrix)
    np.testing.assert_array_equal(jc.dist_coeffs, tc.dist_coeffs)
    for f in ("M", "Minv"):
        np.testing.assert_array_equal(getattr(jw, f), getattr(tw, f))
    for f in ("image_width_height", "warped_width_height", "mppv", "mpph"):
        assert getattr(jw, f) == getattr(tw, f)


@pytest.mark.parametrize("which", ["real", "synthetic"])
def test_grid_builder_copies(which):
    cam, warp = list(_calibrations())[0 if which == "real" else 1]
    img, wsz = warp.image_width_height, warp.warped_width_height
    _assert_grid_dicts_equal(
        j_und.undistort_grid(cam.cam_matrix, cam.dist_coeffs, img),
        t_und.undistort_grid(cam.cam_matrix, cam.dist_coeffs, img))
    _assert_grid_dicts_equal(
        j_hom.perspective_grid(warp.M, img, wsz, mode="float"),
        t_hom.perspective_grid(warp.M, img, wsz))


@pytest.mark.parametrize("which", ["real", "synthetic"])
def test_fused_warp_coords_copy(which):
    """The banded warp's pass-2 coordinates (calib/undistort.py and the
    float64 perspective inverse map it calls)."""
    cam, warp = list(_calibrations())[0 if which == "real" else 1]
    img, wsz = warp.image_width_height, warp.warped_width_height
    for j, t in zip(j_hom.perspective_source_coords(warp.M, wsz),
                    t_hom.perspective_source_coords(warp.M, wsz)):
        np.testing.assert_array_equal(t, j)
    for j, t in zip(
            j_und.fused_undistort_warp_coords(cam.cam_matrix, cam.dist_coeffs,
                                              warp.M, img, wsz),
            t_und.fused_undistort_warp_coords(cam.cam_matrix, cam.dist_coeffs,
                                              warp.M, img, wsz)):
        assert t.dtype == j.dtype == np.float64
        np.testing.assert_array_equal(t, j)


def test_slot_remap_copy():
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    img, wsz = warp.image_width_height, warp.warped_width_height
    for q in (t_und.undistort_grid(cam.cam_matrix, cam.dist_coeffs, img),
              t_hom.perspective_grid(warp.M, img, wsz)):
        j = JGrid.from_quantized(q)
        t = slot_remap(q)
        assert t["src_size"] == j.src_size
        for k in ("base", "w00", "w01", "w10", "w11"):
            np.testing.assert_array_equal(t[k], np.asarray(getattr(j, k)))


def test_config_copy():
    def fields(c):
        return dataclasses.asdict(c)

    assert set(t_cfg.PRESETS) == set(j_cfg.PRESETS)
    for name in j_cfg.PRESETS:
        assert fields(t_cfg.PRESETS[name]) == fields(j_cfg.PRESETS[name])
    assert fields(t_cfg.SECOND_ATTEMPT) == fields(j_cfg.SECOND_ATTEMPT)
    assert fields(t_cfg.TrackerConfig()) == fields(j_cfg.TrackerConfig())


def test_halve_config_copy():
    """'half''s config scaling (config.py:128-180): the odd halving, each
    preset and the default config halved, and SECOND_ATTEMPT_HALF."""
    def fields(c):
        return dataclasses.asdict(c)

    for k in range(1, 130):
        assert t_cfg._odd_half(k) == j_cfg._odd_half(k), k
    for name in j_cfg.PRESETS:
        assert (fields(t_cfg.halve_config(t_cfg.PRESETS[name]))
                == fields(j_cfg.halve_config(j_cfg.PRESETS[name]))), name
    assert (fields(t_cfg.halve_config(t_cfg.TrackerConfig()))
            == fields(j_cfg.halve_config(j_cfg.TrackerConfig())))
    assert (fields(t_cfg.SECOND_ATTEMPT_HALF)
            == fields(j_cfg.SECOND_ATTEMPT_HALF))
    assert t_cfg.SECOND_ATTEMPT_HALF.filter.open_k == 3


def test_ellipse_runs_and_forward_grid_copies():
    for k in (1, 3, 5, 7, 15, 29, 35, 55, 65):
        assert t_runs(k) == j_runs(k)
    for cam, warp in _calibrations():
        ju, jv = j_fwd(warp.M, warp.image_width_height,
                       warp.warped_width_height)
        tu, tv = t_fwd(warp.M, warp.image_width_height,
                       warp.warped_width_height)
        np.testing.assert_array_equal(ju, tu)
        np.testing.assert_array_equal(jv, tv)


def test_roi_grids_copy():
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    img, wsz = warp.image_width_height, warp.warped_width_height
    und_q = t_und.undistort_grid(cam.cam_matrix, cam.dist_coeffs, img)
    pg = t_hom.perspective_grid(warp.M, img, wsz)
    ju, jw, jroi = j_step._roi_grids(und_q, JGrid.from_quantized(pg), img)
    tu, tw, troi = t_step._roi_grids(und_q, slot_remap(pg), img)
    assert jroi == troi == (450, 690)
    for j, t in ((ju, tu), (jw, tw)):
        assert t["src_size"] == j.src_size
        for k in ("base", "w00", "w01", "w10", "w11"):
            np.testing.assert_array_equal(t[k], np.asarray(getattr(j, k)))


def _build_both(pipeline, col_roi=None, which="real"):
    cam, warp = list(_calibrations())[0 if which == "real" else 1]
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    jp = j_step.TrackerParams.build(*args, pipeline=pipeline, col_roi=col_roi)
    tp = t_step.TrackerParams.build(*args, pipeline=pipeline, col_roi=col_roi,
                                    device="cpu")
    return jp, tp


def _assert_params_equal_jax(jp, tp):
    names = (("grid_und", "grid_warp", "unwarp_grid")
             if jp.pipeline == "compat" else ("grid_und_roi", "grid_warp_roi"))
    for name in ("grid_und", "grid_warp", "unwarp_grid", "grid_und_roi",
                 "grid_warp_roi"):
        assert (getattr(tp, name) is None) == (name not in names), name
    for jg, tg in ((getattr(jp, n), getattr(tp, n)) for n in names):
        assert tg.src_size == jg.src_size
        assert tg.dst_shape == tuple(jg.base.shape)
        for k in ("base", "w00", "w01", "w10", "w11"):
            np.testing.assert_array_equal(
                getattr(tg, k).numpy(), np.asarray(getattr(jg, k)).reshape(-1))
    np.testing.assert_array_equal(tp.fwd_u.numpy(), np.asarray(jp.fwd_u))
    np.testing.assert_array_equal(tp.fwd_v.numpy(), np.asarray(jp.fwd_v))
    assert (tp.warp_b_bias is None) == (jp.warp_b_bias is None)
    if jp.warp_b_bias is not None:
        assert tp.warp_b_bias.dtype == torch.float32
        np.testing.assert_array_equal(
            tp.warp_b_bias.numpy(), np.asarray(jp.warp_b_bias).reshape(-1))
    for f in ("img_size", "warped_size", "mppv", "mpph", "pipeline",
              "raw_roi", "col_roi", "col_comp", "res_scale"):
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("pipeline,col_roi,which", [
    ("corridor", None, "real"),
    ("fast", None, "real"),
    ("corridor", (30, 70), "synthetic"),
    ("compat", None, "real"),
    ("compat", None, "synthetic"),
    ("turbo", None, "synthetic"),
    ("half", None, "synthetic"),
])
def test_params_build_equals_jax(pipeline, col_roi, which):
    jp, tp = _build_both(pipeline, col_roi, which)
    _assert_params_equal_jax(jp, tp)
    if pipeline == "corridor" and which == "real":
        assert tp.raw_roi == (450, 690)
        assert tp.grid_und_roi.dst_shape == (238, 1280)
        assert tp.grid_warp_roi.dst_shape == (1100, 672)
        assert tp.col_roi == (320, 832) and tp.col_comp == (240, 912)
    if pipeline == "compat" and which == "real":
        assert tp.raw_roi == (0, 720)
        assert tp.grid_und.dst_shape == (720, 1280)
        assert tp.grid_warp.dst_shape == (1100, 1080)
        assert tp.unwarp_grid.dst_shape == (720, 1280)
        assert tp.unwarp_grid.src_size == (1080, 1100)


@pytest.mark.parametrize("pipeline,which", [("corridor", "real"),
                                            ("fast", "real"),
                                            ("compat", "real"),
                                            ("compat", "synthetic"),
                                            ("turbo", "real"),
                                            ("half", "real")])
def test_params_from_jax_equals_build(pipeline, which):
    jp, tp = _build_both(pipeline, which=which)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    fp = t_step.params_from_jax(leaves, jp.tree_flatten()[1], device="cpu")
    a, b = dict(fp.named_buffers()), dict(tp.named_buffers())
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for f in ("img_size", "warped_size", "mppv", "mpph", "pipeline",
              "raw_roi", "col_roi", "col_comp", "res_scale"):
        assert getattr(fp, f) == getattr(tp, f), f
    for name in ("grid_und", "grid_warp", "unwarp_grid", "grid_und_roi",
                 "grid_warp_roi"):
        fg, tg = getattr(fp, name), getattr(tp, name)
        assert (fg is None) == (tg is None), name
        if tg is not None:
            assert fg.src_size == tg.src_size, name
            assert fg.dst_shape == tg.dst_shape, name


@pytest.mark.parametrize("pipeline", ["turbo", "half"])
def test_unported_pipelines_raise(pipeline):
    """'turbo' and 'half' once raised here; both build now, at full size,
    and their params (grids, fill bias, scaled geometry) equal JAX's."""
    jp, tp = _build_both(pipeline)
    _assert_params_equal_jax(jp, tp)
    if pipeline == "half":
        _, warp = j_load(ASSETS_DIR / "calibration.npz")
        assert tp.res_scale == 2 and tp.warped_size == (540, 550)
        assert (tp.mppv, tp.mpph) == (2 * warp.mppv, 2 * warp.mpph)
        assert tp.grid_warp_roi.dst_shape == (550, 540)
    else:
        assert tp.warp_b_bias.shape == (1100 * 1080,)
        assert float(tp.warp_b_bias.max()) == 128.0


def test_unknown_pipeline_raises_as_jax():
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    with pytest.raises(ValueError, match="pipeline must be") as j_err:
        j_step.TrackerParams.build(*args, pipeline="mxu")
    with pytest.raises(ValueError, match="pipeline must be") as t_err:
        t_step.TrackerParams.build(*args, pipeline="mxu", device="cpu")
    assert str(t_err.value) == str(j_err.value)


def test_state_from_numpy_equals_init_state():
    js = j_init_state(4, 2, 1100)
    ts = state_from_numpy(type(js)(*(np.asarray(x) for x in js)),
                          device="cpu")
    want = init_state(4, 2, 1100, device="cpu")
    assert ts._fields == want._fields == js._fields
    for a, b in zip(ts, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["TrackerParams.build", "params_from_jax",
                                   "make_initial_state", "init_state",
                                   "state_from_numpy", "MxuWarp2.build",
                                   "LaneTracker", "state_from_npz"])
def test_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    """With no ``device`` an entry point puts its tensors on the card, so
    without CUDA it raises; ``device="cpu"`` runs on the CPU."""
    cam, warp = list(_calibrations())[1]
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    js = j_init_state(4, 2, 128)
    j_state_np = type(js)(*map(np.asarray, js))
    j_state_to_npz(js, tmp_path / "state.npz")
    calls = {
        "TrackerParams.build": lambda **kw: t_step.TrackerParams.build(
            *args, pipeline="fast", **kw),
        "params_from_jax": lambda **kw: t_step.params_from_jax(
            *_jax_leaves_aux(args), **kw),
        "make_initial_state": lambda **kw: t_step.make_initial_state(
            t_cfg.PRESETS["demo1"], warp.warped_width_height, **kw),
        "init_state": lambda **kw: init_state(4, 2, 128, **kw),
        "state_from_numpy": lambda **kw: state_from_numpy(
            j_state_np, **kw),
        "MxuWarp2.build": lambda **kw: MxuWarp2.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M,
            warp.image_width_height, (96, 16), **kw),
        "LaneTracker": lambda **kw: TTracker(
            warp.image_width_height, warp.warped_width_height,
            cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
            (warp.mppv, warp.mpph), **kw).params,
        "state_from_npz": lambda **kw: t_state_from_npz(
            tmp_path / "state.npz", **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    out = calls[entry](device="cpu")
    tensors = (list(out.buffers()) if isinstance(out, torch.nn.Module)
               else list(out))
    assert tensors and all(x.device.type == "cpu" for x in tensors)


def _jax_leaves_aux(args):
    jp = j_step.TrackerParams.build(*args, pipeline="fast")
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(jp)],
            jp.tree_flatten()[1])


def _random_state(seed=3):
    """Numpy values of every state field, of the reference's dtypes."""
    rng = np.random.default_rng(seed)
    js = j_init_state(4, 3, 17)
    out = {}
    for name, x in js._asdict().items():
        x = np.asarray(x)
        if x.dtype == np.bool_:
            out[name] = rng.integers(0, 2, x.shape).astype(bool)
        elif x.dtype == np.int32:
            out[name] = rng.integers(-9, 99, x.shape).astype(np.int32)
        else:
            out[name] = rng.normal(size=x.shape).astype(np.float32)
    return type(js)(**out)


def test_state_npz_interchange(tmp_path):
    """A snapshot written by either package loads into the other with
    every field's dtype, shape and value."""
    want = _random_state()
    j_state_to_npz(want, tmp_path / "jax.npz")
    t = state_from_numpy(want, device="cpu")
    t_state_to_npz(t, tmp_path / "port.npz")
    for got in (t_state_from_npz(tmp_path / "jax.npz", device="cpu"),
                j_state_from_npz(tmp_path / "port.npz")):
        assert got._fields == want._fields
        for name, g, w in zip(want._fields, got, want):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(want._fields)


def test_draw_text_copy():
    import lane_tracker_tpu.render.text as j_text
    import lane_tracker_tpu_torch.render.text as t_text

    img = np.random.default_rng(1).integers(0, 256, (120, 300, 3),
                                            dtype=np.uint8)
    for text, org, color in (("Curve Radius: 2280 m", (20, 35), (255,) * 3),
                             ("Eccentricity: -0.07 m", (-10, 70), (0, 200, 9)),
                             ("Frame: 1\u00e9\t?", (250, 118), (255,) * 3),
                             ("Lane Line Detection Failed", (5, 5), (1, 2, 3))):
        a = j_text.draw_text(img.copy(), text, org, color)
        b = t_text.draw_text(img.copy(), text, org, color)
        assert (a != img).any()
        np.testing.assert_array_equal(b, a, err_msg=text)


def test_split_view_copy():
    import lane_tracker_tpu.render.split as j_split
    import lane_tracker_tpu_torch.render.split as t_split

    rng = np.random.default_rng(2)
    top = rng.integers(0, 256, (72, 128, 3), dtype=np.uint8)
    bev = rng.integers(0, 256, (110, 108, 3), dtype=np.uint8)
    viz = rng.integers(0, 256, (110, 108), dtype=np.uint8)
    np.testing.assert_array_equal(t_split.triple_split_view([top, bev, viz]),
                                  j_split.triple_split_view([top, bev, viz]))
    args = ((200, 150), [bev, viz], [(0, 0), (90, 40)],
            [(100, 70), (130, 120)], ("one", "two"))
    np.testing.assert_array_equal(t_split.create_split_view(*args),
                                  j_split.create_split_view(*args))


def test_fps_meter_copy(monkeypatch):
    import lane_tracker_tpu.utils.profiling as j_prof
    import lane_tracker_tpu_torch.utils.profiling as t_prof

    readings = []
    for meter_cls in (j_prof.FpsMeter, t_prof.FpsMeter):
        clock = iter([10.0, 10.5, 11.0, 20.0, 20.0, 20.25])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        m = meter_cls()
        m.add(3)
        got = [m.fps()]
        m.add(np.int64(2))
        got.append(m.fps())
        m.reset()
        got.append(m.fps())
        m.add(1)
        got.append(m.fps())
        readings.append(got)
    assert readings[0] == readings[1] == [6.0, 5.0, 0.0, 4.0]


def test_npz_source_and_sink_copy(tmp_path):
    import lane_tracker_tpu.io.video as j_video
    import lane_tracker_tpu_torch.io.video as t_video

    frames = np.random.default_rng(4).integers(0, 256, (7, 6, 10, 3),
                                               dtype=np.uint8)
    np.savez(tmp_path / "in.npz", frames=frames)
    for mod, tag in ((j_video, "jax"), (t_video, "port")):
        src = mod.open_source(tmp_path / "in.npz")
        assert type(src).__name__ == "NpzSource"
        assert (src.size, src.fps) == ((10, 6), 25.0)
        chunks = list(src.chunks(3))
        sink = mod.open_sink(tmp_path / f"{tag}.npz", src.size, src.fps)
        for chunk, n in chunks:
            sink.write(chunk, n)
        sink.close()
        if tag == "jax":
            want = chunks
    for (a, n), (b, m) in zip(want, chunks):
        assert n == m
        np.testing.assert_array_equal(b, a)
    assert [n for _, n in chunks] == [3, 3, 1]
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        np.testing.assert_array_equal(b["frames"], a["frames"])
        np.testing.assert_array_equal(b["frames"], frames)


def test_calibration_loaders_copy(tmp_path):
    """The reference pickles' loaders and the npz writer."""
    import pickle

    import lane_tracker_tpu.calib.io as j_io
    import lane_tracker_tpu_torch.calib.io as t_io

    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    with open(tmp_path / "cam.p", "wb") as f:
        pickle.dump({"cam_matrix": cam.cam_matrix.tolist(),
                     "dist_coeffs": cam.dist_coeffs}, f)
    with open(tmp_path / "warp.p", "wb") as f:
        pickle.dump({"M": warp.M, "Minv": warp.Minv.tolist(),
                     "image_width_height": warp.image_width_height,
                     "warped_width_height": warp.warped_width_height,
                     "mppv": np.float32(warp.mppv), "mpph": warp.mpph}, f)
    for a, b in zip(t_io.load_camera_calib(tmp_path / "cam.p"),
                    j_io.load_camera_calib(tmp_path / "cam.p")):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tw = t_io.load_warp_params(tmp_path / "warp.p")
    jw = j_io.load_warp_params(tmp_path / "warp.p")
    for a, b in zip(tw, jw):
        assert type(a) is type(b)
        np.testing.assert_array_equal(a, b)
    t_io.save_calibration_npz(tmp_path / "t.npz",
                              *t_load(ASSETS_DIR / "calibration.npz"))
    j_io.save_calibration_npz(tmp_path / "j.npz", cam, warp)
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    (tc, tw2), (jc, jw2) = (t_load(tmp_path / "t.npz"),
                            j_load(tmp_path / "t.npz"))
    np.testing.assert_array_equal(tc.cam_matrix, jc.cam_matrix)
    assert tw2.warped_width_height == jw2.warped_width_height


def test_stills_npz_equals_pil_decode():
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        frames, names = z["frames"], list(z["names"])
    assert names == STILLS
    assert frames.shape == (4, 720, 1280, 3) and frames.dtype == np.uint8
    for f, n in zip(frames, names):
        np.testing.assert_array_equal(
            f, np.asarray(Image.open(ASSETS_DIR / n).convert("RGB")))


def test_homography_solve_and_projection_copies():
    src = [(242, 695), (564, 473), (721, 473), (1064, 695)]
    dst = [(439, 1100), (439, 380), (643, 380), (643, 1100)]
    M = t_hom.get_perspective_transform(src, dst)
    np.testing.assert_array_equal(M, j_hom.get_perspective_transform(src,
                                                                      dst))
    pts = np.random.default_rng(0).uniform(0, 1280, (5, 7, 2))
    np.testing.assert_array_equal(t_hom.project_points(M, pts),
                                  j_hom.project_points(M, pts))


@pytest.mark.parametrize("geometry", [((128, 96), (96, 128)),
                                      ((1280, 720), (1080, 1100))])
def test_synthetic_calibration_and_tiny_config_copies(geometry):
    import lane_tracker_tpu.calib.synthetic as j_syn
    import lane_tracker_tpu_torch.calib.synthetic as t_syn

    (jc, jw), (tc, tw) = (j_syn.make_synthetic_calibration(*geometry),
                          t_syn.make_synthetic_calibration(*geometry))
    assert type(tc).__module__.startswith("lane_tracker_tpu_torch")
    for a, b in ((tc, jc), (tw, jw)):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert type(x) is type(y), f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    tcfg, jcfg = t_syn.tiny_config(), j_syn.tiny_config()
    assert isinstance(tcfg, t_cfg.TrackerConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def _assert_warp_params_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert type(x) is type(y), f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_warp_calibration_copies():
    import lane_tracker_tpu.calib.perspective as j_per
    import lane_tracker_tpu_torch.calib.perspective as t_per

    _assert_warp_params_equal(t_per.reference_warp_calibration(),
                              j_per.reference_warp_calibration())
    args = ([(10.5, 90), (40, 60), (60, 61), (90, 92)],
            [(30, 128), (30, 40), (66, 40), (66, 128)], (128, 96),
            (96, 128), 19.5, 14.0)
    _assert_warp_params_equal(
        t_per.calibrate_warp(*args, patch_width_m=3.5, patch_height_m=3.0),
        j_per.calibrate_warp(*args, patch_width_m=3.5, patch_height_m=3.0))


def test_camera_calibration_copy():
    """``calibrate_camera`` on chessboard corners projected from a known
    camera (no image, no cv2): the port's result is the JAX package's,
    bit for bit, and recovers the camera."""
    import lane_tracker_tpu.calib.camera as j_cam
    import lane_tracker_tpu_torch.calib.camera as t_cam

    obj = t_cam.chessboard_object_points(9, 6)
    np.testing.assert_array_equal(obj, j_cam.chessboard_object_points(9, 6))
    rng = np.random.default_rng(5)
    truth = [1150.0, 1140.0, 640.0, 360.0, -0.24, 0.08, 1e-3, -5e-4, -0.02]
    params = np.array(truth + [v for _ in range(5) for v in (
        *rng.uniform(-0.35, 0.35, 3), *rng.uniform(-4, 4, 2),
        rng.uniform(18, 26))])
    image_points = j_cam._project(params, [obj] * 5)
    got = t_cam.calibrate_camera([obj] * 5, image_points, (1280, 720))
    want = j_cam.calibrate_camera([obj] * 5, image_points, (1280, 720))
    np.testing.assert_array_equal(got[0].cam_matrix, want[0].cam_matrix)
    np.testing.assert_array_equal(got[0].dist_coeffs, want[0].dist_coeffs)
    assert got[1] == want[1]
    for (ra, ta), (rb, tb) in zip(got[2], want[2]):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ta, tb)
    k = got[0].cam_matrix
    np.testing.assert_allclose([k[0, 0], k[1, 1], k[0, 2], k[1, 2]],
                               truth[:4], rtol=1e-6)
    assert got[1] < 1e-6
    with pytest.raises(ValueError, match="3 views"):
        t_cam.calibrate_camera([obj] * 2, image_points[:2], (1280, 720))


def test_calibrate_cli_warp_npz_equals_jax(tmp_path):
    import lane_tracker_tpu.calibrate as j_cli
    import lane_tracker_tpu_torch.calibrate as t_cli

    cam, _ = j_load(ASSETS_DIR / "calibration.npz")
    np.savez(tmp_path / "camera.npz", cam_matrix=cam.cam_matrix,
             dist_coeffs=cam.dist_coeffs)
    argv = ["warp", str(tmp_path / "camera.npz"), "--src", "242,695",
            "564,473", "721,473", "1064,695", "--dst", "439,1100",
            "439,380", "643,380", "643,1100", "--image-size", "1280x720",
            "--warped-size", "1080x1100", "--patch-px", "196x146"]
    assert t_cli.main(argv + ["--out", str(tmp_path / "t.npz")]) == 0
    assert j_cli.main(argv + ["--out", str(tmp_path / "j.npz")]) == 0
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_calibrate_cli_camera_needs_cv2(tmp_path, monkeypatch):
    """Without cv2 (as on the card's machine) ``camera`` raises its clear
    error before reading a photo."""
    import lane_tracker_tpu_torch.calibrate as t_cli

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="requires cv2"):
        t_cli.main(["camera", str(tmp_path / "*.jpg"), "--out",
                    str(tmp_path / "camera.npz")])


def test_debug_mode_raises_at_the_first_non_finite_op():
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from lane_tracker_tpu_torch.utils.debug import debug_mode

    x = torch.tensor([0.0, 1.0])
    with debug_mode():
        y = torch.exp(x) + 1.0  # finite: no error
        torch.empty(64)  # uninitialised memory is not a result
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)
        with pytest.raises(FloatingPointError, match="aten.div"):
            x / x
    assert bool(torch.isfinite(y).all())
    assert _get_current_dispatch_mode() is None
    assert bool(torch.isinf(torch.log(x)).any())  # restored on exit
    with pytest.raises(KeyError):
        with debug_mode():
            raise KeyError("inside")
    assert _get_current_dispatch_mode() is None  # restored after a raise
    with debug_mode(nan_checks=False):
        torch.log(x)


def test_assert_states_equal():
    from lane_tracker_tpu_torch.utils.debug import assert_states_equal

    a = init_state(4, 2, 16, device="cpu")
    assert_states_equal(a, init_state(4, 2, 16, device="cpu"))
    b = a._replace(ecc=a.ecc + 1e-4)
    with pytest.raises(AssertionError, match="ecc"):
        assert_states_equal(a, b)
    assert_states_equal(a, b, atol=1e-3)
    with pytest.raises(AssertionError, match="counter"):
        assert_states_equal(a, a._replace(counter=a.counter + 1), atol=0.5)


# The prologue of a subprocess that cannot import the modules ``mods``
# (their names and submodules), as on a machine without them.
BLOCK_IMPORTS = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        for mod in {mods!r}:
            if name == mod or name.startswith(mod + "."):
                raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
"""

_BLOCKER = BLOCK_IMPORTS + """
import pkgutil, importlib
import lane_tracker_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
assert not any(k == "lane_tracker_tpu" or k.startswith("lane_tracker_tpu.")
               for k in sys.modules), "imported the JAX package"
assert {mod!r} not in sys.modules
for name in ("lane_tracker_tpu_torch.kernels.shift_chain",
             "lane_tracker_tpu_torch.kernels.sweep_dots",
             "lane_tracker_tpu_torch.kernels.tile_gather",
             "lane_tracker_tpu_torch.probes.mosaic",
             "lane_tracker_tpu_torch.probes.filter_redesign",
             "lane_tracker_tpu_torch.timing",
             "lane_tracker_tpu_torch.tracker.tracker",
             "lane_tracker_tpu_torch.render.text",
             "lane_tracker_tpu_torch.render.split",
             "lane_tracker_tpu_torch.render.viz",
             "lane_tracker_tpu_torch.io.video",
             "lane_tracker_tpu_torch.io.native_loader",
             "lane_tracker_tpu_torch.io.motion",
             "lane_tracker_tpu_torch.utils.profiling",
             "lane_tracker_tpu_torch.process_video",
             "lane_tracker_tpu_torch.__main__",
             "lane_tracker_tpu_torch.parallel.streams",
             "lane_tracker_tpu_torch.parallel.mesh",
             "lane_tracker_tpu_torch.calibrate",
             "lane_tracker_tpu_torch.calib.camera",
             "lane_tracker_tpu_torch.calib.perspective",
             "lane_tracker_tpu_torch.calib.synthetic",
             "lane_tracker_tpu_torch.utils.debug"):
    assert name in sys.modules, "not walked: " + name
print("ok")
"""


@pytest.mark.parametrize("blocked", ["jax", "PIL", "lane_tracker_tpu", "cv2"])
def test_port_imports_without(blocked):
    """Every module of the port imports with jax, PIL, OpenCV or the JAX
    package unavailable (the card's machine has neither jax nor PIL nor
    OpenCV), the probes' modules and the motion frames among them."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER.format(mods=(blocked,), mod=blocked)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
