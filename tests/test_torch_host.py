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
    for jg, tg in ((jp.grid_und_roi, tp.grid_und_roi),
                   (jp.grid_warp_roi, tp.grid_warp_roi)):
        assert tg.src_size == jg.src_size
        assert tg.dst_shape == tuple(jg.base.shape)
        for k in ("base", "w00", "w01", "w10", "w11"):
            np.testing.assert_array_equal(
                getattr(tg, k).numpy(), np.asarray(getattr(jg, k)).reshape(-1))
    np.testing.assert_array_equal(tp.fwd_u.numpy(), np.asarray(jp.fwd_u))
    np.testing.assert_array_equal(tp.fwd_v.numpy(), np.asarray(jp.fwd_v))
    for f in ("img_size", "warped_size", "mppv", "mpph", "pipeline",
              "raw_roi", "col_roi", "col_comp"):
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("pipeline,col_roi,which", [
    ("corridor", None, "real"),
    ("fast", None, "real"),
    ("corridor", (30, 70), "synthetic"),
])
def test_params_build_equals_jax(pipeline, col_roi, which):
    jp, tp = _build_both(pipeline, col_roi, which)
    _assert_params_equal_jax(jp, tp)
    if pipeline == "corridor" and which == "real":
        assert tp.raw_roi == (450, 690)
        assert tp.grid_und_roi.dst_shape == (238, 1280)
        assert tp.grid_warp_roi.dst_shape == (1100, 672)
        assert tp.col_roi == (320, 832) and tp.col_comp == (240, 912)


@pytest.mark.parametrize("pipeline", ["corridor", "fast"])
def test_params_from_jax_equals_build(pipeline):
    jp, tp = _build_both(pipeline)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    fp = t_step.params_from_jax(leaves, jp.tree_flatten()[1], device="cpu")
    a, b = dict(fp.named_buffers()), dict(tp.named_buffers())
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for f in ("img_size", "warped_size", "mppv", "mpph", "pipeline",
              "raw_roi", "col_roi", "col_comp"):
        assert getattr(fp, f) == getattr(tp, f), f
    assert fp.grid_und_roi.src_size == tp.grid_und_roi.src_size
    assert fp.grid_warp_roi.src_size == tp.grid_warp_roi.src_size


@pytest.mark.parametrize("pipeline", ["compat", "turbo", "half"])
def test_unported_pipelines_raise(pipeline):
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    with pytest.raises(NotImplementedError, match=pipeline):
        t_step.TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph, pipeline=pipeline, device="cpu")


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
                                   "state_from_numpy", "MxuWarp2.build"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    """With no ``device`` an entry point puts its tensors on the card, so
    without CUDA it raises; ``device="cpu"`` runs on the CPU."""
    cam, warp = list(_calibrations())[1]
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    js = j_init_state(4, 2, 128)
    j_state_np = type(js)(*map(np.asarray, js))
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


def test_stills_npz_equals_pil_decode():
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        frames, names = z["frames"], list(z["names"])
    assert names == STILLS
    assert frames.shape == (4, 720, 1280, 3) and frames.dtype == np.uint8
    for f, n in zip(frames, names):
        np.testing.assert_array_equal(
            f, np.asarray(Image.open(ASSETS_DIR / n).convert("RGB")))


_BLOCKER = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == {mod!r} or name.startswith({mod!r} + "."):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
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
             "lane_tracker_tpu_torch.timing"):
    assert name in sys.modules, "not walked: " + name
print("ok")
"""


@pytest.mark.parametrize("blocked", ["jax", "PIL", "lane_tracker_tpu"])
def test_port_imports_without(blocked):
    """Every module of the port imports with jax, PIL or the JAX package
    unavailable (the card's machine has neither jax nor PIL), the
    probes' modules among them."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER.format(mod=blocked)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
