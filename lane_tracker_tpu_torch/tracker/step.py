"""The tracking step: calibration params, batched front half, back half.

Port of lane_tracker_tpu/tracker/step.py for every pipeline ('fast',
'corridor', 'compat', 'turbo', 'half') and the rowmm latency mode:

* ``TrackerParams`` (step.py:77-305): an ``nn.Module`` whose resampling
  grids and overlay coordinates are buffers, so ``.to(device)`` moves them;
  static geometry stays plain attributes.  ``_roi_grids`` (step.py:351-387)
  and the corridor crop (step.py:239-276) are copied host numpy.  'compat'
  keeps the full-frame undistort and warp grids and the unwarp grid of
  ``Minv`` instead of the ROI grids; 'half' is 'fast' at a scaled
  calibration (``half_geometry``); 'turbo' carries the LAB-B fill bias;
  ``with_rowmm`` adds the latency mode's tile structures.
* ``warp_channels`` (step.py:390-468): the exact two-stage resample
  (fixed-point undistort over the raw rows the warp needs, then the float
  bird's-eye warp) and LAB-B, with the frame batch as a tensor axis;
  'compat' undistorts the whole frame and takes LAB-B by the LUT chain;
  'turbo' takes LAB-B on the undistorted band and warps R and LAB-B as
  one pair with the fill bias; with the rowmm structures either stage
  runs as slab reads and one-hot contractions (bit for bit the gather).
* ``front_artifacts_batch`` (step.py:781-814): warp + LAB, of the whole
  chunk or a slice at a time as a streamed chunk lands, each attempt's
  filter, then each attempt's embedding and search; its one-frame forms
  ``front_half`` (step.py:636) and ``front_artifacts`` (step.py:817), and
  ``second_attempt_artifacts_batch`` (step.py:761-778), ``_embed_cols`` /
  ``_embed_prefixes`` (step.py:471-520), ``_run_attempt``
  (step.py:563-633) with the corridor certificate, ``back_half``
  (step.py:905-1092) with the second attempt hoisted or per frame, and
  ``render_frame`` (step.py:869-902).
* ``tracker_step`` / ``build_step`` (step.py:1095-1116): one frame end to
  end, the front half as a batch of one.

The reference's ``lax.cond`` between band and sliding-window search is
"compute both, ``torch.where``", so the per-frame back half never waits on
the device.  Its per-frame ``lax.cond`` on the second attempt ('cond'
mode) is a host read of attempt 1's validity: only a failing frame runs
the 'neighborhood' filter.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from lane_tracker_tpu_torch.calib.homography import perspective_grid
from lane_tracker_tpu_torch.calib.undistort import undistort_grid
from lane_tracker_tpu_torch.device import DEFAULT_DEVICE, entry_device
from lane_tracker_tpu_torch.kernels.resample import (
    ResampleGrid,
    bilinear_gather,
    bilinear_gather_pair,
    slot_remap,
)
from lane_tracker_tpu_torch.kernels.resample_rowmm import (
    RowMMGrid,
    bilinear_gather_pair_rowmm,
    bilinear_gather_rowmm,
    build_rowmm,
)
from lane_tracker_tpu_torch.ops.color import rgb2lab_b_fast, rgb2lab_b_u8
from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.ops.integrals import RowPrefixes, interval_moments
from lane_tracker_tpu_torch.ops.polyfit import (
    check_validity,
    curve_radius_m,
    eccentricity_m,
    fit_poly_rows,
    ploty_grid,
    poly_points_meta,
)
from lane_tracker_tpu_torch.ops.search import (
    SearchIntervals,
    band_intervals,
    sliding_window_intervals,
    sws_precompute,
)
from lane_tracker_tpu_torch.render.lane import (
    forward_bv_grid,
    lane_overlay,
    lane_overlay_direct,
    lane_region_mask,
)
from lane_tracker_tpu_torch.tracker.config import (
    SECOND_ATTEMPT,
    SECOND_ATTEMPT_HALF,
    TrackerConfig,
)
from lane_tracker_tpu_torch.tracker.state import TrackerState, init_state
from lane_tracker_tpu_torch.tracker.upload import StreamedChunk
from lane_tracker_tpu_torch.utils.profiling import (
    count,
    host_read,
    span,
    unit,
)

PIPELINES = ("fast", "compat", "turbo", "corridor", "half")
# The corridor's compute margin, the JAX package's (step.py:265), which it
# sizes by a filter reach of 75.  By ``filter_reach`` in
# tests/test_torch_filter_reach.py the reach is 93 (the cross threshold's
# arms are ksize pixels long), so a crafted input can change the kept edge
# columns (that file's corridor-margin test); kept at 80 so that
# 'corridor' equals JAX's.
CORRIDOR_MARGIN = 80


def _roi_grids(und_q: dict, g_warp: dict, img_size):
    """Row-crop the two-stage resampling chain to what is actually sampled
    (copied from the reference, step.py:351-387; pure index rebasing).

    Returns (g_und_roi, g_warp_roi, (ry0, ry1)) as slot-remapped dicts:
    the undistort grid restricted to the rows the warp samples and reading
    raw rows [ry0, ry1), and the warp grid rebased onto that band.
    """
    Wc, Hc = int(img_size[0]), int(img_size[1])
    wb = g_warp["base"]
    y0 = int((wb // Wc).min())
    y1 = min(int((wb // Wc).max()) + 2, Hc)  # +1 down tap, +1 exclusive
    und_rows = {
        k: (v[y0:y1] if isinstance(v, np.ndarray) and v.ndim == 2 else v)
        for k, v in und_q.items()
    }
    g_und_band = slot_remap(und_rows)
    ub = g_und_band["base"]
    ry0 = int((ub // Wc).min())
    ry1 = min(int((ub // Wc).max()) + 2, Hc)
    g_und_roi = dict(g_und_band, base=ub - np.int32(ry0 * Wc),
                     src_size=(Wc, ry1 - ry0))
    g_warp_roi = dict(g_warp, base=wb - np.int32(y0 * Wc),
                      src_size=(Wc, y1 - y0))
    return g_und_roi, g_warp_roi, (ry0, ry1)


def half_geometry(M, Minv, warped_size, mppv, mpph):
    """The 'half' pipeline's scaled calibration (step.py:193-214): the
    half-resolution pixel (x, y) has its centre at full-resolution
    (2x + 0.5, 2y + 0.5), so M_h = S @ M with S = [[.5, 0, -.25], [0, .5,
    -.25], [0, 0, 1]], Minv_h = Minv @ S^-1, the warped size halves and
    the metres per pixel double.  Returns (M_h, Minv_h, warped_size_h,
    mppv_h, mpph_h)."""
    S = np.array([[0.5, 0.0, -0.25],
                  [0.0, 0.5, -0.25],
                  [0.0, 0.0, 1.0]])
    return (S @ np.asarray(M), np.asarray(Minv) @ np.linalg.inv(S),
            (int(warped_size[0]) // 2, int(warped_size[1]) // 2),
            float(mppv) * 2, float(mpph) * 2)


def _tensor(x) -> torch.Tensor:
    """A tensor as it is, else a copy of an array as a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _grid_bias(g_warp: dict) -> np.ndarray:
    """'turbo''s LAB-B fill bias of a remapped warp grid: float32
    128 * (1 - the weights' sum) a destination pixel (step.py:281-285);
    LAB-B of black is 128, but out-of-image taps carry weight 0."""
    wsum = g_warp["w00"] + g_warp["w01"] + g_warp["w10"] + g_warp["w11"]
    return 128.0 * (1.0 - wsum.astype(np.float32))


class TrackerParams(nn.Module):
    """Calibration-derived constants of a pipeline.

    Buffers: the resampling grids ('fast', 'corridor', 'turbo' and
    'half': the two ROI grids; 'compat': the full-frame undistort and warp
    grids and the unwarp grid, the others None), the direct overlay's
    per-camera-pixel bird's-eye coordinates (``fwd_u``, ``fwd_v``),
    'turbo''s ``warp_b_bias`` (flattened over the warped pixels) and the
    latency mode's ``mm_und`` / ``mm_warp`` (``with_rowmm``).  Attributes:
    the static geometry, as the reference's pytree aux; 'half' holds the
    scaled geometry with ``res_scale`` 2.
    """

    def __init__(self, grid_und_roi: ResampleGrid | None,
                 grid_warp_roi: ResampleGrid | None, fwd_u, fwd_v, *,
                 img_size, warped_size, mppv, mpph, pipeline, raw_roi,
                 col_roi=None, col_comp=None, grid_und=None, grid_warp=None,
                 unwarp_grid=None, res_scale=1, warp_b_bias=None,
                 mm_und: RowMMGrid | None = None,
                 mm_warp: RowMMGrid | None = None):
        super().__init__()
        if pipeline not in PIPELINES:
            raise ValueError("pipeline must be 'fast', 'compat', 'turbo', "
                             "'corridor' or 'half'")
        self.grid_und_roi = grid_und_roi
        self.grid_warp_roi = grid_warp_roi
        self.grid_und = grid_und
        self.grid_warp = grid_warp
        self.unwarp_grid = unwarp_grid
        self.mm_und = mm_und
        self.mm_warp = mm_warp
        self.register_buffer("fwd_u", _tensor(fwd_u))
        self.register_buffer("fwd_v", _tensor(fwd_v))
        self.register_buffer(
            "warp_b_bias",
            None if warp_b_bias is None
            else _tensor(warp_b_bias).float().reshape(-1))
        self.img_size = tuple(int(v) for v in img_size)
        self.warped_size = tuple(int(v) for v in warped_size)
        self.mppv = float(mppv)
        self.mpph = float(mpph)
        self.pipeline = pipeline
        self.raw_roi = tuple(int(v) for v in raw_roi)
        self.col_roi = None if col_roi is None else tuple(map(int, col_roi))
        self.col_comp = None if col_comp is None else tuple(map(int, col_comp))
        self.res_scale = int(res_scale)

    @classmethod
    def build(cls, cam_matrix, dist_coeffs, M, Minv, img_size, warped_size,
              mppv, mpph, pipeline: str = "fast",
              col_roi: tuple | None = None,
              device=DEFAULT_DEVICE) -> "TrackerParams":
        """Host-side build from a calibration, with the buffers on
        ``device`` (the card unless the caller passes ``device="cpu"``).
        Only the 'compat' unwarp reads ``Minv``.  'half' builds 'fast' at
        ``half_geometry``'s scaled calibration; its configs must be scaled
        with ``config.halve_config`` (``LaneTracker`` does this)."""
        device = entry_device(device)
        img_size = tuple(int(v) for v in img_size)
        warped_size = tuple(int(v) for v in warped_size)
        res_scale = 1
        if pipeline == "half":
            res_scale = 2
            M, Minv, warped_size, mppv, mpph = half_geometry(
                M, Minv, warped_size, mppv, mpph)
        fu, fv = forward_bv_grid(np.asarray(M), img_size, warped_size)
        und_q = undistort_grid(cam_matrix, dist_coeffs, img_size)
        g_warp = slot_remap(
            perspective_grid(np.asarray(M), img_size, warped_size))
        geometry = dict(img_size=img_size, warped_size=warped_size,
                        mppv=mppv, mpph=mpph, pipeline=pipeline,
                        res_scale=res_scale)
        if pipeline == "compat":
            unwarp = perspective_grid(np.asarray(Minv), warped_size, img_size)
            return cls(
                None, None, fu, fv, raw_roi=(0, img_size[1]),
                grid_und=ResampleGrid.from_remapped(slot_remap(und_q)),
                grid_warp=ResampleGrid.from_remapped(g_warp),
                unwarp_grid=ResampleGrid.from_remapped(slot_remap(unwarp)),
                **geometry,
            ).to(device)
        g_und_roi, g_warp_roi, raw_roi = _roi_grids(und_q, g_warp, img_size)
        col_comp = None
        if pipeline == "corridor":
            # Warp/LAB/filter compute warped columns [c0, c1) = the decision
            # corridor [x0, x1) plus the margin; decisions keep [x0, x1).
            if col_roi is None:
                col_roi = (320, 832)
            cx0, cx1 = int(col_roi[0]), int(col_roi[1])
            if not (0 <= cx0 < cx1 <= warped_size[0]):
                raise ValueError(f"col_roi {col_roi} outside warped width")
            col_roi = (cx0, cx1)
            cc0 = max(0, cx0 - CORRIDOR_MARGIN)
            cc1 = min(warped_size[0], cx1 + CORRIDOR_MARGIN)
            col_comp = (cc0, cc1)
            g_warp_roi = dict(g_warp_roi, **{
                k: g_warp_roi[k][:, cc0:cc1]
                for k in ("base", "w00", "w01", "w10", "w11")})
        else:
            col_roi = None
        return cls(
            ResampleGrid.from_remapped(g_und_roi),
            ResampleGrid.from_remapped(g_warp_roi),
            fu, fv, raw_roi=raw_roi, col_roi=col_roi, col_comp=col_comp,
            warp_b_bias=(_grid_bias(g_warp_roi) if pipeline == "turbo"
                         else None),
            **geometry,
        ).to(device)

    def _replaced(self, grid=lambda g: g, **changes) -> "TrackerParams":
        """A new TrackerParams with each grid, tile structure and buffer
        passed through ``grid`` and the fields in ``changes`` replaced;
        the static geometry is shared."""
        def opt(x):
            return None if x is None else grid(x)

        fields = dict(
            grid_und_roi=opt(self.grid_und_roi),
            grid_warp_roi=opt(self.grid_warp_roi),
            fwd_u=grid(self.fwd_u), fwd_v=grid(self.fwd_v),
            img_size=self.img_size, warped_size=self.warped_size,
            mppv=self.mppv, mpph=self.mpph, pipeline=self.pipeline,
            raw_roi=self.raw_roi, col_roi=self.col_roi,
            col_comp=self.col_comp, grid_und=opt(self.grid_und),
            grid_warp=opt(self.grid_warp), unwarp_grid=opt(self.unwarp_grid),
            res_scale=self.res_scale, warp_b_bias=opt(self.warp_b_bias),
            mm_und=opt(self.mm_und), mm_warp=opt(self.mm_warp))
        fields.update(changes)
        und, warp, fu, fv = (fields.pop(k) for k in (
            "grid_und_roi", "grid_warp_roi", "fwd_u", "fwd_v"))
        return TrackerParams(und, warp, fu, fv, **fields)

    def copy_to(self, device) -> "TrackerParams":
        """A new TrackerParams with a copy of every buffer on ``device``
        (the fleet's ``parallel.mesh.replicate``): each grid copied, the
        static geometry shared."""
        device = entry_device(device)
        return self._replaced(lambda x: (
            x.to(device, copy=True) if isinstance(x, torch.Tensor)
            else x.copy_to(device)))

    def with_rowmm(self) -> "TrackerParams":
        """Params carrying the latency mode's tile structures (step.py:
        158-173): the two-stage warp runs as slab reads + one-hot
        contractions (kernels/resample_rowmm.py), bit for bit the gather.
        The one-hot tensors take about 380 MB on the card ('fast').
        'compat', and params without ROI grids, return themselves; a grid
        with no tile structure keeps its gather."""
        if self.pipeline == "compat" or self.grid_und_roi is None:
            return self
        dev = self.fwd_u.device

        def mm(g):
            built = build_rowmm(g)
            return None if built is None else built.to(dev)

        return self._replaced(mm_und=mm(self.grid_und_roi),
                              mm_warp=mm(self.grid_warp_roi))


def _rowmm_from_jax(leaves: list, grids) -> list:
    """The latency mode's tile structures of params from the JAX package:
    each rebuilt from its carried grid (``build_rowmm``, whose sizes and
    meta the reference keeps in the treedef), then held equal to the
    carried (iy0, starts, onehot) leaves, three a structure, in order."""
    built = [build_rowmm(g) for g in grids]
    present = [m for m in built if m is not None]
    if len(leaves) != 3 * len(present):
        raise ValueError(f"{len(leaves)} rowmm leaves for "
                         f"{len(present)} tile structures")
    for i, m in enumerate(present):
        iy0, starts, onehot = leaves[3 * i:3 * i + 3]
        if not (np.array_equal(iy0, m.iy0.numpy())
                and np.array_equal(starts, m.starts.numpy())
                and np.array_equal(np.asarray(onehot, np.float32),
                                   m.onehot.float().numpy())):
            raise ValueError("the carried rowmm leaves differ from the "
                             "structure of their grid")
    return built


def params_from_jax(leaves, aux, device=DEFAULT_DEVICE) -> TrackerParams:
    """The port's params from the JAX package's ``TrackerParams``, with
    the buffers on ``device`` (the card unless the caller passes
    ``device="cpu"``).

    ``leaves``: ``jax.tree_util.tree_leaves(params)`` as numpy arrays, in
    the reference's order (grid_und, grid_warp, grid_und_roi,
    grid_warp_roi, unwarp_grid as five leaves each, then fwd_u, fwd_v,
    'turbo''s warp_b_bias, then with ``with_rowmm`` the (iy0, starts,
    onehot) of mm_und and mm_warp; a None has no leaves, so 'compat',
    without the ROI grids, has 17, 'fast' 27, 'turbo' 28); ``aux``:
    ``params.tree_flatten()[1]``.  Every pipeline is accepted, 'half'
    with its ``res_scale`` of 2.
    """
    device = entry_device(device)
    (img_size, warped_size, mppv, mpph, pipeline, raw_roi, _backend, col_roi,
     col_comp, res_scale) = aux
    if pipeline not in PIPELINES or res_scale != (2 if pipeline == "half"
                                                  else 1):
        raise ValueError(f"params of pipeline {pipeline!r} with res_scale "
                         f"{res_scale}")
    leaves = [np.asarray(x) for x in leaves]
    geometry = dict(img_size=img_size, warped_size=warped_size, mppv=mppv,
                    mpph=mpph, pipeline=pipeline, raw_roi=raw_roi,
                    res_scale=res_scale)
    if pipeline == "compat":
        if len(leaves) != 17:
            raise ValueError(f"'compat' params with {len(leaves)} leaves")
        return TrackerParams(
            None, None, leaves[15], leaves[16],
            grid_und=ResampleGrid(*leaves[0:5], src_size=img_size),
            grid_warp=ResampleGrid(*leaves[5:10], src_size=img_size),
            unwarp_grid=ResampleGrid(*leaves[10:15], src_size=warped_size),
            **geometry,
        ).to(device)
    und = leaves[10:15]
    warp = leaves[15:20]
    g_und = ResampleGrid(*und, src_size=(img_size[0], raw_roi[1] - raw_roi[0]))
    g_warp = ResampleGrid(*warp, src_size=(img_size[0], und[0].shape[0]))
    n = 28 if pipeline == "turbo" else 27
    if len(leaves) < n:
        raise ValueError(f"{pipeline!r} params with {len(leaves)} leaves")
    mm_und, mm_warp = (_rowmm_from_jax(leaves[n:], (g_und, g_warp))
                       if len(leaves) > n else (None, None))
    return TrackerParams(
        g_und, g_warp, leaves[25], leaves[26], col_roi=col_roi,
        col_comp=col_comp, warp_b_bias=leaves[27] if n == 28 else None,
        mm_und=mm_und, mm_warp=mm_warp, **geometry,
    ).to(device)


class StepOutput(NamedTuple):
    overlay: torch.Tensor | None  # (Hc, Wc, 3) uint8 — lane-highlighted frame
    render_mode: torch.Tensor  # () i32: 0 = lane drawn, 1 = failure text
    valid: torch.Tensor  # () bool
    detected: torch.Tensor  # () bool
    search_mode: torch.Tensor  # () i32: 0 = sliding window, 1 = band
    n_attempts: torch.Tensor  # () i32
    radius: torch.Tensor  # () f32 — smoothed curve radius shown (m)
    ecc: torch.Tensor  # () f32 — eccentricity shown (m)
    left_coeffs: torch.Tensor  # (3,) f32 — this frame's raw fit
    right_coeffs: torch.Tensor  # (3,) f32
    n_points_left: torch.Tensor  # () i32
    n_points_right: torch.Tensor  # () i32
    a1_detected: torch.Tensor
    a1_valid: torch.Tensor
    a1_left_coeffs: torch.Tensor
    a1_right_coeffs: torch.Tensor
    a1_n_left: torch.Tensor
    a1_n_right: torch.Tensor
    # 'corridor': every read this frame's attempts made stayed inside the
    # corridor, so its decision trace equals full-width 'fast'.
    corridor_ok: torch.Tensor


class AttemptResult(NamedTuple):
    detected: torch.Tensor
    valid: torch.Tensor
    lc: torch.Tensor
    rc: torch.Tensor
    search_mode: torch.Tensor
    n_left: torch.Tensor
    n_right: torch.Tensor
    roi_ok: torch.Tensor


class FrontArtifacts(NamedTuple):
    """Per-frame products of the stateless front half (a leading T axis
    on every field for a chunk, none for one frame)."""

    r_chan: torch.Tensor  # (T, H, W) u8 warped R, compute window
    b_chan: torch.Tensor  # (T, H, W) u8 warped LAB-B, compute window
    pref: RowPrefixes  # (T, H, W+1) attempt-1 binary prefixes
    iv_sws: SearchIntervals  # attempt-1 blind-search intervals, (T, ...)
    pref2: RowPrefixes | None = None  # hoisted attempt-2 binary prefixes
    iv_sws2: SearchIntervals | None = None  # hoisted attempt-2 intervals


class RenderMeta(NamedTuple):
    """Per-frame inputs of the overlay renderers."""

    fitx_left: torch.Tensor  # (H,) f32 — smoothed graph ('compat' mask)
    fitx_right: torch.Tensor
    coeffs_left: torch.Tensor  # (3,) f32 — smoothed coefficients rendered
    coeffs_right: torch.Tensor
    n_left: torch.Tensor
    n_right: torch.Tensor
    first_left: torch.Tensor
    first_right: torch.Tensor
    draw: torch.Tensor  # () bool


class WarpChain(NamedTuple):
    """The two-stage resample of a pipeline, as ``warp_rows`` runs it:
    the undistort grid (reading the raw rows ``params.raw_roi``), the warp
    grid, the LAB-B function, and 'turbo''s order with its fill bias (one
    value a warped pixel of ``g_warp``), and the latency mode's tile
    structures (None: the per-pixel gather)."""

    g_und: ResampleGrid
    g_warp: ResampleGrid
    lab: Callable
    turbo: bool = False
    bias: torch.Tensor | None = None
    mm_und: RowMMGrid | None = None
    mm_warp: RowMMGrid | None = None


def warp_chain(params: TrackerParams) -> WarpChain:
    """The two-stage resample of ``params``.  'fast', 'corridor', 'turbo'
    and 'half' undistort the raw rows the warp samples and take LAB-B by
    the float path; 'compat' undistorts the whole frame and takes LAB-B by
    the LUT chain."""
    if params.pipeline == "compat":
        return WarpChain(params.grid_und, params.grid_warp, rgb2lab_b_u8)
    return WarpChain(params.grid_und_roi, params.grid_warp_roi,
                     rgb2lab_b_fast, turbo=params.pipeline == "turbo",
                     bias=params.warp_b_bias, mm_und=params.mm_und,
                     mm_warp=params.mm_warp)


def _gather(img: torch.Tensor, grid: ResampleGrid, mm: RowMMGrid | None):
    """``bilinear_gather``, by the tile structure ``mm`` where there is
    one (bit for bit the same)."""
    if mm is None:
        return bilinear_gather(img, grid)
    return bilinear_gather_rowmm(img, grid, mm)


def warp_rows(raw: torch.Tensor, chain: WarpChain):
    """Warped R and LAB-B of (T, rows, Wc, 3) uint8 raw rows, the rows
    ``chain``'s undistort grid reads, in the reference's order of
    operations (step.py:417-468): the undistort, then for 'turbo' LAB-B of
    the undistorted band and one pair resample of (R, LAB-B) with the fill
    bias, else the warp of the RGB and LAB-B of the warped frame."""
    und = _gather(raw, chain.g_und, chain.mm_und)
    if chain.turbo:
        # 'turbo' (step.py:433-455): interpolate(LAB(x)) instead of
        # LAB(interpolate(x)) across the warp, a measured approximation.
        r_u, lab_u = und[..., 0].contiguous(), chain.lab(und)
        if chain.mm_warp is None:
            return bilinear_gather_pair(r_u, lab_u, chain.g_warp,
                                        bias_b=chain.bias)
        return bilinear_gather_pair_rowmm(r_u, lab_u, chain.g_warp,
                                          chain.mm_warp, bias_b=chain.bias)
    warped = _gather(und, chain.g_warp, chain.mm_warp)
    return warped[..., 0].contiguous(), chain.lab(warped)


def warp_channels(frames: torch.Tensor, params: TrackerParams):
    """Warped R and LAB-B channels of a (T, Hc, Wc, 3) uint8 chunk.

    The reference's exact two-stage chain: fixed-point undistort of the raw
    rows the warp samples, then the float bird's-eye warp (cropped to the
    corridor's compute columns), then LAB-B of the warped RGB.  'compat'
    undistorts the whole frame and takes LAB-B by the LUT chain; 'turbo'
    warps LAB-B of the undistorted band (``warp_rows``)."""
    r0, r1 = params.raw_roi
    return warp_rows(frames[:, r0:r1], warp_chain(params))


def _embed_cols(binary: torch.Tensor, params: TrackerParams) -> torch.Tensor:
    """Keep the decision corridor's columns of a compute-window binary and
    embed them into the full warped width (zeros outside [x0, x1))."""
    if params.col_roi is None:
        return binary
    x0, x1 = params.col_roi
    c0, _ = params.col_comp
    out = binary.new_zeros(binary.shape[:-1] + (params.warped_size[0],))
    out[..., x0:x1] = binary[..., x0 - c0:x1 - c0]
    return out


def _embed_prefixes(pref: RowPrefixes, params: TrackerParams) -> RowPrefixes:
    """Rebase compute-window packed prefixes onto the full width, keeping
    only the corridor's pixels: counts carry over, x-sums shift by
    c0 * count, X <= x0 holds 0 and X > x1 the corridor total."""
    if params.col_roi is None:
        return pref
    x0, x1 = params.col_roi
    c0, c1 = params.col_comp
    W = params.warped_size[0]
    packed = pref.packed
    Wcm = packed.shape[-1] - 1
    if Wcm != c1 - c0:
        raise ValueError(f"prefix width {Wcm} != compute window {c1 - c0}")
    shift_c = (Wcm + 1).bit_length()
    shift_f = (W + 1).bit_length()
    a, b = x0 - c0, x1 - c0
    cnt = packed & ((1 << shift_c) - 1)
    xs = packed >> shift_c
    seg_cnt = cnt[..., a:b + 1] - cnt[..., a:a + 1]
    seg_xs = xs[..., a:b + 1] - xs[..., a:a + 1] + c0 * seg_cnt
    repacked = (seg_xs << shift_f) | seg_cnt
    out = packed.new_zeros(packed.shape[:-1] + (W + 1,))
    out[..., x0:x1 + 1] = repacked
    out[..., x1 + 1:] = repacked[..., -1:]
    return RowPrefixes(packed=out)


def _sa_config(params: TrackerParams) -> TrackerConfig:
    """The hardcoded second-attempt parameter set (lane_tracker.py:
    1081-1099), scaled where the warped space is ('half', step.py:676)."""
    return SECOND_ATTEMPT_HALF if params.res_scale == 2 else SECOND_ATTEMPT


def has_second_attempt(config: TrackerConfig) -> bool:
    """n_tries >= 2, or -1 (unbounded), runs the second attempt."""
    return config.n_tries >= 2 or config.n_tries == -1


def _embed_search(binary: torch.Tensor, pref: RowPrefixes,
                  params: TrackerParams, scfg):
    """Corridor-embedded prefixes and blind sliding-window intervals of a
    (T, H, W) compute-window binary and its prefixes.  'corridor''s
    embedding onto the full width runs in an ``lt.corridor.embed`` span."""
    W, H = params.warped_size
    if params.col_roi is not None:
        with span("lt.corridor.embed"):
            binary = _embed_cols(binary, params)
            pref = _embed_prefixes(pref, params)
    iv = sliding_window_intervals(sws_precompute(binary, scfg), scfg, H, W)
    return pref, iv


def second_attempt_artifacts_batch(r_chan: torch.Tensor, b_chan: torch.Tensor,
                                   params: TrackerParams):
    """Attempt-2 front products (state-free) of a (T, H, W) channel batch:
    the hardcoded 'neighborhood' filter (lane_tracker.py:1081-1099), its
    embedded prefixes and blind intervals.  Returns (pref2, iv_sws2)."""
    sa = _sa_config(params)
    binary2, pref2 = filter_stage(r_chan, b_chan, sa.filter)
    return _embed_search(binary2, pref2, params, sa.search)


def _warp_slices(chunk, params: TrackerParams):
    """``warp_channels`` of a ``tracker.upload.StreamedChunk``, a slice at
    a time as each slice lands, into (T, ...) planes: the same planes bit
    for bit, since the warp is frame-local."""
    planes = None
    for lo, part in chunk.slices():
        with span("lt.warp_lab"):
            parts = warp_channels(part, params)
            if planes is None:
                planes = tuple(x.new_empty((chunk.shape[0],) + x.shape[1:])
                               for x in parts)
            for plane, x in zip(planes, parts):
                plane[lo:lo + x.shape[0]] = x
    return planes


def front_artifacts_batch(frames: torch.Tensor | StreamedChunk,
                          params: TrackerParams, config: TrackerConfig,
                          hoist_second_attempt: bool = False
                          ) -> FrontArtifacts:
    """Stateless front half for a (T, Hc, Wc, 3) uint8 chunk: warp, LAB,
    the attempt-1 filter (three kernels), corridor embedding, and the
    blind sliding-window intervals, all batched over T.  With
    ``hoist_second_attempt`` (and a config that has a second attempt) the
    attempt-2 filter and search run too, for every frame.  ``frames`` is a
    device tensor, warped whole, or a ``tracker.upload.StreamedChunk`` of
    host frames, warped a slice at a time as each slice lands
    (``_warp_slices``)."""
    if isinstance(frames, torch.Tensor):
        with span("lt.warp_lab"):
            r_chan, b_chan = warp_channels(frames, params)
    else:
        r_chan, b_chan = _warp_slices(frames, params)
    with span("lt.filter"):
        binary, pref = filter_stage(r_chan, b_chan, config.filter)
    sa = (_sa_config(params)
          if hoist_second_attempt and has_second_attempt(config) else None)
    if sa is not None:
        with span("lt.second_attempt"):
            binary2, pref2 = filter_stage(r_chan, b_chan, sa.filter)
    with span("lt.embed_search"):
        pref, iv_sws = _embed_search(binary, pref, params, config.search)
    arts = FrontArtifacts(r_chan, b_chan, pref, iv_sws)
    if sa is None:
        return arts
    with span("lt.second_attempt"):
        pref2, iv2 = _embed_search(binary2, pref2, params, sa.search)
    return arts._replace(pref2=pref2, iv_sws2=iv2)


def front_half(frame: torch.Tensor, params: TrackerParams,
               config: TrackerConfig):
    """One (Hc, Wc, 3) uint8 frame's stateless front half (step.py:636):
    (warped R, warped LAB-B, the attempt-1 binary embedded into the full
    warped width)."""
    r_chan, b_chan = warp_channels(frame[None], params)
    binary, _ = filter_stage(r_chan, b_chan, config.filter)
    return r_chan[0], b_chan[0], _embed_cols(binary, params)[0]


def front_artifacts(frame: torch.Tensor, params: TrackerParams,
                    config: TrackerConfig,
                    hoist_second_attempt: bool = False) -> FrontArtifacts:
    """Everything the back half needs of one (Hc, Wc, 3) uint8 frame
    (step.py:817): ``front_artifacts_batch`` of a batch of one, without
    the T axis."""
    return frame_artifacts(front_artifacts_batch(
        frame[None], params, config, hoist_second_attempt), 0)


def _run_attempt(state: TrackerState, cfg: TrackerConfig, scfg, params,
                 ploty_validity, pref: RowPrefixes,
                 iv_sws: SearchIntervals) -> AttemptResult:
    """One search + fit + validate attempt on one frame's O(H) data."""
    with span("lt.back_half.attempt"):
        W, H = params.warped_size
        use_band = state.last_detection <= cfg.n_reset
        iv_band = band_intervals(state.last_left, state.last_right, scfg, H, W)
        iv = SearchIntervals(*(torch.where(use_band, b, s)
                               for b, s in zip(iv_band, iv_sws)))
        ln, lsx = interval_moments(pref, iv.left_lo, iv.left_hi,
                                   iv.left_valid)
        rn, rsx = interval_moments(pref, iv.right_lo, iv.right_hi,
                                   iv.right_valid)
        detected = (ln.sum() > 0) & (rn.sum() > 0)
        coeffs = fit_poly_rows(torch.stack([ln, rn]),
                               torch.stack([lsx, rsx]), W)
        meta = poly_points_meta(coeffs, ploty_validity, params.warped_size)
        lc, rc = coeffs[0], coeffs[1]
        validity = check_validity(lc, rc, meta.n[0], meta.n[1],
                                  params.warped_size, cfg.validity)
        if params.col_roi is None:
            roi_ok = torch.ones((), dtype=torch.bool, device=lc.device)
        else:
            # Exactness certificate: every binary column this attempt read
            # lies in the corridor (per-level conv reads, then the selected
            # row intervals), so its decisions equal full-width 'fast'.
            x0, x1 = params.col_roi

            def rng_ok(lo, hi, nonempty):
                return torch.where(nonempty, (lo >= x0) & (hi <= x1),
                                   True).all()

            roi_ok = (
                rng_ok(iv.left_read_lo, iv.left_read_hi,
                       iv.left_read_lo < iv.left_read_hi)
                & rng_ok(iv.right_read_lo, iv.right_read_hi,
                         iv.right_read_lo < iv.right_read_hi)
                & rng_ok(iv.left_lo, iv.left_hi,
                         iv.left_valid & (iv.left_lo < iv.left_hi))
                & rng_ok(iv.right_lo, iv.right_hi,
                         iv.right_valid & (iv.right_lo < iv.right_hi))
            )
        return AttemptResult(
            detected=detected,
            valid=detected & validity,
            lc=lc,
            rc=rc,
            search_mode=use_band.to(torch.int32),
            n_left=meta.n[0],
            n_right=meta.n[1],
            roi_ok=roi_ok,
        )


def back_half(state: TrackerState, art: FrontArtifacts,
              params: TrackerParams, config: TrackerConfig):
    """Sequential back half of one frame: search, fit, validate, the
    second attempt where attempt 1 failed, state update.  ``art`` holds
    one frame's artifacts (no T axis).  Returns (new_state, StepOutput
    without the overlay, RenderMeta).

    With ``art.pref2`` (hoisted) attempt 2 runs unconditionally and each
    field is selected by attempt 1's validity; without it ('cond') one host
    read of that validity decides, and only a failing frame runs the
    'neighborhood' filter on its own (1, H, W) channels."""
    dev = state.last_left.device
    ploty_validity = ploty_grid(params.warped_size, 1.0, dev)

    a1 = _run_attempt(state, config, config.search, params, ploty_validity,
                      art.pref, art.iv_sws)
    if has_second_attempt(config):
        sa = _sa_config(params)
        if art.pref2 is not None:
            a2 = _run_attempt(state, config, sa.search, params,
                              ploty_validity, art.pref2, art.iv_sws2)
            a = AttemptResult(*(torch.where(a1.valid, x, y)
                                for x, y in zip(a1, a2)))
        elif bool(host_read(a1.valid)):
            a = a1
        else:
            with span("lt.second_attempt"):
                pref2, iv2 = second_attempt_artifacts_batch(
                    art.r_chan[None], art.b_chan[None], params)
            a = _run_attempt(state, config, sa.search, params,
                             ploty_validity, RowPrefixes(pref2.packed[0]),
                             SearchIntervals(*(f[0] for f in iv2)))
        n_attempts = torch.where(a1.valid, 1, 2).to(torch.int32)
    else:
        a = a1
        n_attempts = torch.ones((), dtype=torch.int32, device=dev)
    with span("lt.back_half.update"):
        return _update(state, a, a1, n_attempts, params, config)


def _update(state: TrackerState, a: AttemptResult, a1: AttemptResult,
            n_attempts: torch.Tensor, params: TrackerParams,
            config: TrackerConfig):
    """The back half's update of one frame from its selected attempt
    ``a`` (``a1`` attempt 1's): the rolling history, the smoothed fit, the
    render geometry, the radius and the eccentricity.  Returns
    (new_state, StepOutput without the overlay, RenderMeta)."""
    H = params.warped_size[1]
    ploty_render = ploty_grid(params.warped_size, config.search.partial,
                              state.last_left.device)
    valid = a.valid

    # ---- Rolling history (push on both paths; sentinel = invalid) ----
    new_l = torch.where(valid, a.lc, 0.0)
    new_r = torch.where(valid, a.rc, 0.0)
    hist_left = torch.cat([state.hist_left[1:], new_l[None]])
    hist_right = torch.cat([state.hist_right[1:], new_r[None]])
    hist_valid = torch.cat([state.hist_valid[1:], valid[None]])
    last_left = torch.where(valid, a.lc, state.last_left)
    last_right = torch.where(valid, a.rc, state.last_right)
    last_detection = torch.where(valid, 0, state.last_detection + 1).to(
        torch.int32)

    # ---- Smoothed coefficients over valid history entries ----
    wv = hist_valid.float()
    denom = wv.sum().clamp(min=1.0)
    avg_left_new = (wv[:, None] * hist_left).sum(0) / denom
    avg_right_new = (wv[:, None] * hist_right).sum(0) / denom
    avg_left = torch.where(valid, avg_left_new, state.avg_left)
    avg_right = torch.where(valid, avg_right_new, state.avg_right)
    has_avg = state.has_avg | valid

    # ---- Render geometry from the smoothed fit (success only) ----
    mrender = poly_points_meta(torch.stack([avg_left_new, avg_right_new]),
                               ploty_render, params.warped_size)
    pad = H - mrender.fitx.shape[-1]
    fitx = torch.nn.functional.pad(mrender.fitx, (0, pad))
    rfitx_left = torch.where(valid, fitx[0], state.rfitx_left)
    rfitx_right = torch.where(valid, fitx[1], state.rfitx_right)
    rn_left = torch.where(valid, mrender.n[0], state.rn_left)
    rn_right = torch.where(valid, mrender.n[1], state.rn_right)
    rfirst_left = torch.where(valid, mrender.first[0], state.rfirst_left)
    rfirst_right = torch.where(valid, mrender.first[1], state.rfirst_right)

    # ---- Curve radius rolling state ----
    rl = curve_radius_m(a.lc, params.warped_size, params.mppv, params.mpph)
    rr = curve_radius_m(a.rc, params.warped_size, params.mppv, params.mpph)
    frame_radius = torch.trunc(0.5 * (rl + rr))
    radii = torch.cat([state.radii[1:],
                       torch.where(valid, frame_radius, -1.0)[None]])
    pos = radii > 0
    n_pos = pos.sum().clamp(min=1)
    avg_radius_new = torch.trunc(torch.where(pos, radii, 0.0).sum() / n_pos)
    avg_radius = torch.where(valid, avg_radius_new, state.avg_radius)

    # ---- Eccentricity from the bottom-most smoothed graph points ----
    n_samples = mrender.fitx.shape[-1]
    bottom = (mrender.first + mrender.n - 1).clamp(0, n_samples - 1)
    lrb = torch.trunc(torch.gather(mrender.fitx, -1, bottom.long()[:, None]))
    ecc_new = eccentricity_m(lrb[0, 0], lrb[1, 0], params.warped_size,
                             params.mpph)
    ecc = torch.where(valid, ecc_new, state.ecc)

    new_state = TrackerState(
        last_detection=last_detection,
        hist_left=hist_left,
        hist_right=hist_right,
        hist_valid=hist_valid,
        last_left=last_left,
        last_right=last_right,
        avg_left=avg_left,
        avg_right=avg_right,
        has_avg=has_avg,
        rfitx_left=rfitx_left,
        rfitx_right=rfitx_right,
        rn_left=rn_left,
        rn_right=rn_right,
        rfirst_left=rfirst_left,
        rfirst_right=rfirst_right,
        radii=radii,
        avg_radius=avg_radius,
        ecc=ecc,
        counter=state.counter + 1,
        success=state.success + valid.to(torch.int32),
    )

    # ---- Render decision: lane, previous lane in the grace period, or
    # pass-through for the failure message ----
    draw = valid | (state.has_avg & (last_detection <= config.n_fail))
    meta = RenderMeta(
        fitx_left=rfitx_left,
        fitx_right=rfitx_right,
        coeffs_left=avg_left,
        coeffs_right=avg_right,
        n_left=rn_left,
        n_right=rn_right,
        first_left=rfirst_left,
        first_right=rfirst_right,
        draw=draw,
    )
    out = StepOutput(
        overlay=None,
        render_mode=torch.where(draw, 0, 1).to(torch.int32),
        valid=valid,
        detected=a.detected,
        search_mode=a.search_mode,
        n_attempts=n_attempts,
        radius=avg_radius,
        ecc=ecc,
        left_coeffs=a.lc,
        right_coeffs=a.rc,
        n_points_left=a.n_left,
        n_points_right=a.n_right,
        a1_detected=a1.detected,
        a1_valid=a1.valid,
        a1_left_coeffs=a1.lc,
        a1_right_coeffs=a1.rc,
        a1_n_left=a1.n_left,
        a1_n_right=a1.n_right,
        # a1 always ran; `a` is the selected attempt, whose roi_ok is a2's
        # exactly when a2 was taken (a1 invalid).
        corridor_ok=a1.roi_ok & a.roi_ok,
    )
    return new_state, out, meta


def render_frame(frames: torch.Tensor, meta: RenderMeta,
                 params: TrackerParams, config: TrackerConfig) -> torch.Tensor:
    """Overlays for a (T, Hc, Wc, 3) chunk from T-stacked RenderMeta:
    'compat' unwarps the lane mask, the others draw in camera space."""
    if params.pipeline == "compat":
        mask = lane_region_mask(params.warped_size, meta.fitx_left,
                                meta.fitx_right, meta.n_left, meta.n_right,
                                meta.first_left, meta.first_right)
        return lane_overlay(frames, mask, params.unwarp_grid, meta.draw)
    W, H = params.warped_size
    partial = config.search.partial
    num = int(H * partial)
    start = H * (1.0 - partial)
    step = ((H - 1.0) - start) / (num - 1) if num > 1 else 1.0
    return lane_overlay_direct(
        frames, meta.coeffs_left, meta.coeffs_right, meta.n_left,
        meta.n_right, meta.first_left, meta.first_right, params.fwd_u,
        params.fwd_v, params.warped_size, start, step, meta.draw)


def frame_artifacts(arts: FrontArtifacts, t: int) -> FrontArtifacts:
    """Frame t's artifacts of a T-stacked FrontArtifacts, without the T
    axis."""

    def at(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x[t]
        return type(x)(*(f[t] for f in x))

    return FrontArtifacts(*(at(x) for x in arts))


def tracker_step(state: TrackerState, frame: torch.Tensor,
                 params: TrackerParams, config: TrackerConfig):
    """One (Hc, Wc, 3) uint8 frame end to end: the front half as a batch
    of one, the back half with the second attempt per frame (the
    reference's ``lax.cond``: only a failing frame runs the
    'neighborhood' filter), the overlay.  Returns (new_state, StepOutput)
    without a T axis."""
    frames = frame[None]
    with unit("lt.frame", 1):
        arts = front_artifacts_batch(frames, params, config)
        with span("lt.back_half"):
            count("lt.back_half.frames")
            new_state, out, meta = back_half(state, frame_artifacts(arts, 0),
                                             params, config)
        with span("lt.overlay"):
            overlay = render_frame(frames,
                                   RenderMeta(*(x[None] for x in meta)),
                                   params, config)
    return new_state, out._replace(overlay=overlay[0])


@functools.lru_cache(maxsize=32)
def build_step(config: TrackerConfig):
    """The per-frame step closure for a static config (cached per
    config, as the reference caches its jitted step)."""

    def step(state, frame, params):
        return tracker_step(state, frame, params, config)

    return step


def make_initial_state(config: TrackerConfig, warped_size,
                       device=DEFAULT_DEVICE) -> TrackerState:
    """A fresh state on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    return init_state(config.n_reset, config.n_average, int(warped_size[1]),
                      device)
