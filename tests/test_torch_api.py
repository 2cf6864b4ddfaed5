"""The JAX package's public names, and their counterparts in the port.

Each name the port adds to close the gap is held to its JAX function on
the same numpy inputs (JAX on the CPU through XLA, the port on the CPU):

* ``parallel.build_chunk_processor`` on T=4 frames (stills 0, 1, 3 and a
  black frame in place of still 2, so the second attempt runs), demo1,
  'corridor', in each second-attempt mode: decisions and the integer
  state identical, curves within 0.01 px RMSE, overlays within 1;
* ``tracker.step.front_half`` and ``front_artifacts`` on one frame, and
  'fast''s ``front_artifacts_batch`` on two frames: every field identical;
* ``ops.polyfit.fit_poly_mask`` (curves within 0.01 px RMSE: the fit
  contract) and ``metric_coeffs`` (identical);
* ``ops.filters.filter_lane_points``, ``ops.threshold.
  bilateral_adaptive_threshold``, ``kernels.resample.bilinear_gather_pair``
  and ``calib.undistort.fused_undistort_warp_grid``: identical.

And every name in the ``__all__`` of the JAX package and of each of its
subpackages resolves in the port's counterpart, or stands below as
renamed or not ported, with the reason.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from tests.conftest import ASSETS_DIR
from tests.test_torch_pipeline import (
    assert_outputs_match,
    assert_states_match,
    curve_rmse,
    port_config,
)
from tests.test_torch_pipeline_full import _calib_args

from lane_tracker_tpu.calib import undistort as j_undistort
from lane_tracker_tpu.calib.synthetic import make_synthetic_calibration
from lane_tracker_tpu.calib.homography import perspective_grid as j_pgrid
from lane_tracker_tpu.kernels import resample as j_resample
from lane_tracker_tpu.ops import filters as j_filters
from lane_tracker_tpu.ops import polyfit as j_polyfit
from lane_tracker_tpu.ops import threshold as j_threshold
from lane_tracker_tpu.parallel import pipeline as j_pipeline
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

from lane_tracker_tpu_torch.calib import undistort as t_undistort
from lane_tracker_tpu_torch.kernels import resample as t_resample
from lane_tracker_tpu_torch.ops import filters as t_filters
from lane_tracker_tpu_torch.ops import polyfit as t_polyfit
from lane_tracker_tpu_torch.ops import threshold as t_threshold
from lane_tracker_tpu_torch.parallel import pipeline as t_pipeline
from lane_tracker_tpu_torch.tracker import step as t_step

CFG = PRESETS["demo1"]
SUBPACKAGES = ("", "calib", "io", "kernels", "ops", "parallel", "render",
               "tracker", "utils")
# JAX names whose port has another name: (port module, port name).
RENAMED = {
    "kernels.filter_stage_v2": ("ops.filters", "filter_stage"),
    "utils.trace_annotation": ("utils.profiling", "span"),
}
# JAX names the port does not carry, with the reason (none at present:
# every exported name has its counterpart).
NOT_PORTED = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Full-size frames through PyTorch's CPU operators: with the suite's
    workers sharing the cores, the intra-op thread pool makes each far
    dearer than the work.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stills4():
    """Stills 0, 1 and 3 with a black frame in place of still 2."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        frames = z["frames"].copy()
    frames[2] = 0
    return frames


@pytest.fixture(scope="module")
def corridor():
    args = _calib_args()
    jp = j_step.TrackerParams.build(*args, pipeline="corridor",
                                    filter_backend="xla")
    tp = t_step.TrackerParams.build(*args, pipeline="corridor", device="cpu")
    return jp, tp


@pytest.mark.parametrize("mode", ["two_phase", "hoist", "cond"])
def test_build_chunk_processor_matches_jax(corridor, mode):
    jp, tp = corridor
    frames = _stills4()
    j_fn = j_pipeline.build_chunk_processor(CFG, with_overlay=True,
                                            second_attempt=mode)
    t_fn = t_pipeline.build_chunk_processor(port_config(CFG),
                                            with_overlay=True,
                                            second_attempt=mode)
    assert t_fn is t_pipeline.build_chunk_processor(
        port_config(CFG), with_overlay=True, second_attempt=mode)
    j_state, jo = j_fn(j_step.make_initial_state(CFG, jp.warped_size),
                       frames, jp)
    t_state, to = t_fn(t_step.make_initial_state(CFG, tp.warped_size, "cpu"),
                       torch.from_numpy(frames), tp)
    assert not np.asarray(jo.a1_valid)[2]
    assert_outputs_match(jo, to, jp.warped_size[1])
    assert_states_match(j_state, t_state)


def test_build_chunk_processor_hoist_spelling(corridor):
    """``hoist_second_attempt=True`` is 'hoist', as the reference's."""
    _, tp = corridor
    frames = torch.from_numpy(_stills4()[:2])

    def run(fn):
        return fn(t_step.make_initial_state(CFG, tp.warped_size, "cpu"),
                  frames, tp)[1]

    cfg = port_config(CFG)
    a = run(t_pipeline.build_chunk_processor(cfg, False, True))
    b = run(t_pipeline.build_chunk_processor(cfg, False,
                                             second_attempt="hoist"))
    assert a.overlay is None
    for name, x in a._asdict().items():
        assert x is None or torch.equal(x, getattr(b, name)), name
    with pytest.raises(ValueError, match="unknown second_attempt"):
        t_pipeline.build_chunk_processor(cfg, second_attempt="both")


def _arrays(tree):
    """The leaves of a NamedTuple tree (nested NamedTuples flattened),
    None kept, as numpy arrays."""
    out = []
    for x in tree:
        if x is None:
            out.append(None)
        elif isinstance(x, tuple):
            out += _arrays(x)
        else:
            out.append(x.numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x))
    return out


def assert_leaves_equal(got, want):
    """Every leaf of two NamedTuple trees identical, None where None."""
    a, b = _arrays(got), _arrays(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if y is None:
            assert x is None, i
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=str(i))


@pytest.mark.parametrize("hoist", [False, True])
def test_front_half_and_front_artifacts_match_jax(corridor, hoist):
    jp, tp = corridor
    frame = _stills4()[0]
    want = jax.jit(lambda f, p: (
        j_step.front_half(f, p, CFG),
        j_step.front_artifacts(f, p, CFG, hoist)))(frame, jp)
    t_frame = torch.from_numpy(frame)
    got = (t_step.front_half(t_frame, tp, port_config(CFG)),
           t_step.front_artifacts(t_frame, tp, port_config(CFG), hoist))
    for part_got, part_want in zip(got, want):
        assert_leaves_equal(part_got, part_want)


def test_fast_front_artifacts_batch_matches_jax():
    """tests/test_parallel.py's frames (911, 971), 'fast', demo1: JAX's
    per-frame ``front_artifacts`` (XLA) against the port's batched front
    half, every field identical."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        fr = z["frames"][:2]
    args = _calib_args()
    jp = j_step.TrackerParams.build(*args, pipeline="fast",
                                    filter_backend="xla")
    tp = t_step.TrackerParams.build(*args, pipeline="fast", device="cpu")
    want = jax.jit(lambda f, p: jax.vmap(
        lambda x: j_step.front_artifacts(x, p, CFG))(f))(fr, jp)
    got = t_step.front_artifacts_batch(torch.from_numpy(fr), tp,
                                       port_config(CFG))
    assert_leaves_equal(got, want)


def _random_masks(seed, n=6, H=120, W=160):
    """Masks with two noisy curved strokes, some sparse."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, H, W), np.uint8)
    y = np.arange(H)
    for i in range(n):
        a, b, c = rng.uniform(-4e-3, 4e-3), rng.uniform(-0.5, 0.5), \
            rng.uniform(20, W - 20)
        x = np.clip(a * (y - H / 2) ** 2 + b * (y - H / 2) + c, 0, W - 3)
        keep = rng.random(H) < rng.uniform(0.2, 1.0)
        for dx in range(3):
            masks[i, y[keep], (x[keep] + dx).astype(int)] = 255
    return masks


@pytest.mark.parametrize("seed", range(3))
def test_fit_poly_mask_matches_jax(seed):
    masks = _random_masks(seed)
    got = t_polyfit.fit_poly_mask(torch.from_numpy(masks))
    for m, g in zip(masks, got.numpy()):
        want = np.asarray(j_polyfit.fit_poly_mask(m > 0))
        assert curve_rmse(g, want, m.shape[0]) <= 0.01


def test_metric_coeffs_match_jax():
    rng = np.random.default_rng(3)
    coeffs = np.stack([rng.uniform(-1e-3, 1e-3, 50), rng.uniform(-1, 1, 50),
                       rng.uniform(0, 1000, 50)], -1).astype(np.float32)
    mppv, mpph = 3.0 / 110, 3.7 / 380
    got = t_polyfit.metric_coeffs(torch.from_numpy(coeffs), mppv, mpph)
    want = np.stack([np.asarray(j_polyfit.metric_coeffs(c, mppv, mpph))
                     for c in coeffs])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def warped_rgb():
    """A bird's-eye crop of the stills: rows 550-710, columns 200-520 of
    each, the lane markings on the road."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        return np.ascontiguousarray(z["frames"][:2, 550:710, 200:520])


@pytest.mark.parametrize("kw", [
    {}, {"mask_noise": True}, {"filter_type": "neighborhood", "ksize_r": 15,
                               "C_r": 5}])
def test_filter_lane_points_matches_jax(warped_rgb, kw):
    got = t_filters.filter_lane_points(torch.from_numpy(warped_rgb), **kw)
    for frame, g in zip(warped_rgb, got.numpy()):
        want = np.asarray(j_filters.filter_lane_points(frame, **kw))
        np.testing.assert_array_equal(g, want)
    one = t_filters.filter_lane_points(torch.from_numpy(warped_rgb[0]), **kw)
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("ksize,C,mode,values", [
    (30, 0, "floor", (255, 0)), (25, 8, "floor", (255, 0)),
    (35, 5, "ceil", (255, 0)), (7, -3, "floor", (1, 9)),
    (65, 10, "ceil", (200, 17))])
def test_bilateral_adaptive_threshold_matches_jax(warped_rgb, ksize, C, mode,
                                                  values):
    img = warped_rgb[0, ..., 1]
    kw = dict(ksize=ksize, C=C, mode=mode, true_value=values[0],
              false_value=values[1])
    got = t_threshold.bilateral_adaptive_threshold(torch.from_numpy(img),
                                                   **kw)
    want = np.asarray(j_threshold.bilateral_adaptive_threshold(img, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="mode"):
        t_threshold.bilateral_adaptive_threshold(torch.from_numpy(img),
                                                 mode="mid")


@pytest.mark.parametrize("which", ["float", "fixed"])
def test_bilinear_gather_pair_matches_jax(which):
    """Through the tiny calibration's warp grid (float weights) and its
    fused undistort + warp grid quantized (fixed): each output exactly
    JAX's pair and the port's two single gathers."""
    cam, warp = make_synthetic_calibration()
    src, dst = warp.image_width_height, warp.warped_width_height
    if which == "float":
        grid = j_pgrid(warp.M, src, dst)
    else:
        grid = j_undistort.fused_undistort_warp_grid(
            cam.cam_matrix, cam.dist_coeffs, warp.M, src, dst, mode="fixed")
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 256, (2, src[1], src[0]), dtype=np.uint8)
    want = j_resample.bilinear_gather_pair(
        a, b, j_resample.ResampleGrid.from_quantized(grid))
    tg = t_resample.ResampleGrid.from_remapped(t_resample.slot_remap(grid))
    got = t_resample.bilinear_gather_pair(torch.from_numpy(a),
                                          torch.from_numpy(b), tg)
    for g, w, img in zip(got, want, (a, b)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        single = t_resample.bilinear_gather(
            torch.from_numpy(img)[None, ..., None], tg)[0, ..., 0]
        assert torch.equal(g, single)
    batch = t_resample.bilinear_gather_pair(
        torch.from_numpy(np.stack([a, b])), torch.from_numpy(np.stack([b, a])),
        tg)
    assert torch.equal(batch[0][0], got[0]) and torch.equal(batch[1][0],
                                                            got[1])


@pytest.mark.parametrize("mode", ["float", "fixed"])
def test_fused_undistort_warp_grid_copy(mode):
    cam, warp = make_synthetic_calibration()
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.image_width_height,
            warp.warped_width_height)
    want = j_undistort.fused_undistort_warp_grid(*args, mode=mode)
    got = t_undistort.fused_undistort_warp_grid(*args, mode=mode)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert tuple(got[k]) == tuple(v), k


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_exported_names_resolve_in_the_port(sub):
    """Every name of the JAX (sub)package's ``__all__`` is in the port's
    ``__all__`` there and resolves, or is renamed or not ported above."""
    suffix = f".{sub}" if sub else ""
    j_mod = importlib.import_module("lane_tracker_tpu" + suffix)
    t_mod = importlib.import_module("lane_tracker_tpu_torch" + suffix)
    for name in j_mod.__all__:
        key = f"{sub}.{name}" if sub else name
        if key in NOT_PORTED:
            continue
        if key in RENAMED:
            mod, new = RENAMED[key]
            target = importlib.import_module(f"lane_tracker_tpu_torch.{mod}")
            assert callable(getattr(target, new)), key
            continue
        assert name in t_mod.__all__, key
        assert getattr(t_mod, name) is not None, key
