"""The 'compat' pipeline against the JAX package's, at full size.

'compat' is the reference's chain without the ROI crop: the fixed-point
undistort of the whole 1280x720 frame, the float bird's-eye warp of all
three channels to 1080x1100, LAB-B by OpenCV's integer LUT chain
(``rgb2lab_b_u8``), and an overlay drawn as the reference's draw_lane
does: the lane region as a bird's-eye mask (``lane_region_mask``),
unwarped to the camera through the float grid of ``Minv`` and added as
``rint(0.3 * g)`` of green (``lane_overlay``).

* The chunk: both packages' ``chunk_process`` on the four stills (T=4,
  demo1, two_phase, fresh state), JAX on its XLA filter chain, the port on
  the CPU.  Decisions and the integer state identical, curves within 0.01
  px RMSE, overlays within 1 unit; the renderer held apart as
  tests/test_torch_pipeline_presets.py holds demo3's (the chunk's overlay
  is the port's drawing of its own render inputs, exactly; the port draws
  JAX's overlay from JAX's render inputs within 1 unit).
* The warp: the order in which the float combine's four tap products are
  summed decides the last bit of a float32 sum.  In JAX's optimized CPU
  HLO of 'compat''s warp, each single-channel gather (R, G and B alone,
  and likewise the lane mask's unwarp) sums
  ``((p00 w00 + p01 w01) + p10 w10) + p11 w11`` in one fusion, which the
  CPU backend contracts into
  ``fma(p11, w11, fma(p10, w10, fma(p00, w00, p01 * w01)))``: the order
  the port's ``combine_taps`` forms (the pair gather's R order).  So the
  warped R, LAB-B and the unwarped overlay are held bit-exact, per frame
  and batched.
* ``rgb2lab_u8`` and ``rgb2lab_b_u8`` (integer throughout) bit-exact on a
  seeded random image and on every (r, g, b) of a 16-step lattice.
* ``lane_region_mask`` exact, on the last frame's render inputs (JAX's
  final state) and on partly visible graphs.
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_pipeline import assert_outputs_match
from tests.test_torch_pipeline_presets import (
    assert_render_matches,
    assert_state_matches,
    run_full_chunk,
    stills,
)

from lane_tracker_tpu.ops import color as j_color
from lane_tracker_tpu.render import lane as j_lane
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

from lane_tracker_tpu_torch.ops import color as t_color
from lane_tracker_tpu_torch.render import lane as t_lane
from lane_tracker_tpu_torch.tracker import step as t_step

T = 4


@pytest.fixture(scope="module")
def run():
    return run_full_chunk(PRESETS["demo1"], stills(T), "compat")


def test_compat_chunk_matches_jax(run):
    assert np.asarray(run.jo.valid).all()
    assert run.tp.raw_roi == (0, 720) and run.tp.grid_und_roi is None
    assert_outputs_match(run.jo, run.to, run.H)
    assert_state_matches(run.j_state, run.t_state)


def test_compat_render_matches_jax(run):
    assert_render_matches(run)


def test_compat_warp_channels_bit_exact(run):
    """R and LAB-B of the four stills through 'compat''s warp, against
    JAX's ``_warp_channels`` jitted per frame and batched."""
    frames = run.frames
    tr, tb = t_step.warp_channels(torch.from_numpy(frames), run.tp)
    one = jax.jit(lambda f, p: j_step._warp_channels(f, p))
    batch = jax.jit(lambda f, p: j_step._warp_channels_batch(f, p))
    jr, jb = (np.asarray(x) for x in batch(frames, run.jp))
    assert tr.shape == (T, 1100, 1080)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(tb.numpy(), jb)
    for t in (0, 3):
        r1, b1 = (np.asarray(x) for x in one(frames[t], run.jp))
        np.testing.assert_array_equal(tr[t].numpy(), r1)
        np.testing.assert_array_equal(tb[t].numpy(), b1)


def _lattice():
    v = list(range(0, 256, 16)) + [255]
    grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    return grid.astype(np.uint8)[None]


@pytest.mark.parametrize("which", ["random", "lattice"])
def test_lut_lab_bit_exact(which):
    img = (np.random.default_rng(12).integers(0, 256, (131, 197, 3),
                                              dtype=np.uint8)
           if which == "random" else _lattice())
    x = torch.from_numpy(img)
    lab = t_color.rgb2lab_u8(x)
    assert lab.dtype == torch.uint8 and lab.shape == img.shape
    np.testing.assert_array_equal(lab.numpy(),
                                  np.asarray(j_color.rgb2lab_u8(img)))
    np.testing.assert_array_equal(t_color.rgb2lab_b_u8(x).numpy(),
                                  np.asarray(j_color.rgb2lab_b_u8(img)))
    np.testing.assert_array_equal(t_color.rgb2lab_b_u8(x).numpy(),
                                  lab[..., 2].numpy())


def _jax_masks(ws, fl, fr, nl, nr, al, ar):
    return np.asarray(jax.jit(jax.vmap(
        lambda *a: j_lane.lane_region_mask(ws, *a)))(fl, fr, nl, nr, al, ar))


def test_lane_region_mask_exact(run):
    ws = run.jp.warped_size
    H = ws[1]
    rng = np.random.default_rng(5)
    # Partly visible graphs: fewer samples than rows, a first index past 0,
    # x beyond both edges.
    n = np.array([H, 700, 300, 0], np.int32)
    first = np.array([0, 13, 400, 0], np.int32)
    fl = rng.uniform(-50, 600, (4, H)).astype(np.float32)
    fr = (fl + rng.uniform(-20, 700, (4, H))).astype(np.float32)
    cases = [(fl, fr, n, n[::-1].copy(), first, first[::-1].copy())]
    st = run.j_state
    cases.append(tuple(np.asarray(getattr(st, f))[None] for f in (
        "rfitx_left", "rfitx_right", "rn_left", "rn_right", "rfirst_left",
        "rfirst_right")))
    for args in cases:
        want = _jax_masks(ws, *args)
        got = t_lane.lane_region_mask(ws, *(torch.from_numpy(np.array(a))
                                            for a in args))
        assert got.dtype == torch.uint8 and got.shape == want.shape
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got.numpy(), want)


def test_lane_overlay_unwarp_exact(run):
    """The unwarp gather of a lane mask and the saturating add, against
    JAX's ``lane_overlay`` on the same masks, enabled and not."""
    ws = run.jp.warped_size
    masks = np.zeros((T, ws[1], ws[0]), np.uint8)
    for t in range(T):
        x0 = 380 + 20 * t
        masks[t, 200 + 100 * t:, x0:x0 + 330] = 255
    enable = np.array([True, True, False, True])
    frames = run.frames.copy()
    frames[1, ..., 1] = 240  # saturates where the lane adds more than 15
    want = np.asarray(jax.jit(jax.vmap(
        lambda f, m, e, g: j_lane.lane_overlay(f, m, g, e),
        in_axes=(0, 0, 0, None)))(frames, masks, enable,
                                  run.jp.unwarp_grid))
    got = t_lane.lane_overlay(torch.from_numpy(frames),
                              torch.from_numpy(masks),
                              run.tp.unwarp_grid, torch.from_numpy(enable))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[..., 1] != frames[..., 1]).any()
    np.testing.assert_array_equal(want[2], frames[2])


def test_compat_grids_equal_jax(run):
    """The full-frame grids 'compat' keeps instead of the ROI grids."""
    for name in ("grid_und", "grid_warp", "unwarp_grid"):
        jg, tg = getattr(run.jp, name), getattr(run.tp, name)
        assert tg.src_size == jg.src_size and tg.dst_shape == jg.base.shape
        for k in ("base", "w00", "w01", "w10", "w11"):
            np.testing.assert_array_equal(
                getattr(tg, k).numpy(), np.asarray(getattr(jg, k)).reshape(-1),
                err_msg=f"{name}.{k}")
