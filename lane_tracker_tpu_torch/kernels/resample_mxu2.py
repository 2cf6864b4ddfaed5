"""The banded warp ``MxuWarp2``: fused undistort + bird's-eye warp in two
passes, with pass 2 a hand-written CUDA kernel.

Port of scripts/resample_mxu2.py, the round-2 'mxu' warp that the tracker
does not use (lane_tracker_tpu/tracker/step.py:220-225): it is a runnable
artifact of the JAX package, and its Pallas kernel ``_pass2_call`` is one
of the TPU kernels the port carries.  The warp implements the one-pass
fused resampling map, so it differs from the tracker's exact two-stage
chain (``tracker.step.warp_channels``); that difference is the design's
documented fidelity loss.

* ``build`` / ``build_tables`` copy ``_curve_y_at_cols`` and the host
  build (resample_mxu2.py:65-207) verbatim, float64 numpy.
* Pass 1 (vertical): for every output row z and source column xs, the
  lerp of the two source rows around where row z's preimage curve crosses
  column xs.  Plain PyTorch: two ``index_select`` gathers per channel
  (the reference packs both channels' pairs in one u32 word, a TPU
  gather-count device that is not carried over), then
  ``t0 * w0 + t1 * w1`` in f32 as separate products and one add, the
  order JAX evaluates it in (eagerly, op by op).
* Pass 2 (horizontal): ``pass2``, every output pixel the lerp of its two
  t1 taps, ``clip(rint(fma(t1[x0+1], w1, t1[x0] * w0)), 0, 255)``.  That
  is the order the reference's f32 ``jnp.dot`` (640 products, two of them
  non-zero) forms on the CPU; the kernel (csrc/resample_mxu2.cu,
  ``lt_banded_pass2``) uses ``__fmaf_rn`` to match, and the plain twin
  ``pass2_plain`` takes the fma in float64, rounded once to f32 (one
  rounding whenever the two addends' bits span at most 53 places, as
  ``kernels.resample.fma_f32``).  The TPU kernel's band DMA and its
  mostly-zero (640, 128) weight tile on the MXU are a TPU layout, not the
  function, and are not carried over; t1 stays in (T, C, Ho, Ws) order,
  so the reference's two transposes go too.

``pass2`` on a CUDA tensor launches the kernel or raises; on a CPU tensor
it runs the twin.  Every launch adds one to ``LAUNCHES["banded_pass2"]``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lane_tracker_tpu_torch.calib.undistort import (
    distort_points,
    fused_undistort_warp_coords,
)
from lane_tracker_tpu_torch.device import DEFAULT_DEVICE, entry_device
from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.kernels.filter_stage import _call, _one_device

LANE = 128
SOURCE = {"banded_pass2": "lane_tracker_tpu_torch/csrc/resample_mxu2.cu"}
REPLACES = {"banded_pass2": "scripts/resample_mxu2.py:296"}
LAUNCHES = {"banded_pass2": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _curve_y_at_cols(cam_matrix, dist_coeffs, M, src_size, dst_size,
                     oversample=2, margin=2200):
    """ys(z, xs): where output row z's preimage curve crosses each integer
    source column (NaN outside the monotone field-of-view segment).

    The curve is parameterized by continuous output x', trimmed to its
    maximal monotone segment (distortion fold-back appears beyond the
    field of view), and interpolated at integer columns; float64 host math.
    """
    Ws = int(src_size[0])
    Wo, Ho = int(dst_size[0]), int(dst_size[1])
    xs_par = np.arange(-margin, Wo + margin, 1.0 / oversample, dtype=np.float64)
    Minv = np.linalg.inv(np.asarray(M, dtype=np.float64))
    X, Y = np.meshgrid(xs_par, np.arange(Ho, dtype=np.float64))
    w = Minv[2, 0] * X + Minv[2, 1] * Y + Minv[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_w = np.where(np.abs(w) > 1e-9, 1.0 / w, np.nan)
    ux = (Minv[0, 0] * X + Minv[0, 1] * Y + Minv[0, 2]) * inv_w
    uy = (Minv[1, 0] * X + Minv[1, 1] * Y + Minv[1, 2]) * inv_w
    csx, csy = distort_points(cam_matrix, dist_coeffs, ux, uy)

    cols = np.arange(Ws, dtype=np.float64)
    n_samples = csx.shape[1]
    center = n_samples // 2
    ys = np.full((Ho, Ws), np.nan)
    for z in range(Ho):
        rx, ry = csx[z], csy[z]
        finite = np.isfinite(rx) & np.isfinite(ry)
        d = np.diff(rx)
        good = finite[:-1] & finite[1:] & (d > 0)
        bad_left = np.flatnonzero(~good[:center])
        lo = int(bad_left[-1]) + 1 if bad_left.size else 0
        bad_right = np.flatnonzero(~good[center:])
        hi = center + int(bad_right[0]) if bad_right.size else n_samples - 1
        rx, ry = rx[lo:hi + 1], ry[lo:hi + 1]
        if rx.size < 2:
            continue
        ys[z] = np.interp(cols, rx, ry, left=np.nan, right=np.nan)
    return ys


def build_tables(cam_matrix, dist_coeffs, M, src_size, dst_size,
                 band: int = 640) -> dict:
    """The host build of ``MxuWarp2.build`` (resample_mxu2.py:129-207):
    numpy ``v_base`` (Ho, Ws) i32, ``v_w0`` / ``v_w1`` (Ho, Ws) f32,
    ``wpack`` (Ho, n_tiles, 4, LANE) f32 with per-tile rows [x0, w0, w1,
    0], ``tile_base`` (Ho * n_tiles,) i32, and ``geom`` (Ws, Hs, Wo, Ho,
    band)."""
    Ws, Hs = int(src_size[0]), int(src_size[1])
    Wo, Ho = int(dst_size[0]), int(dst_size[1])
    Ws_pad = -(-Ws // LANE) * LANE
    band = min(-(-int(band) // LANE) * LANE, Ws_pad)
    Wo_pad = -(-Wo // LANE) * LANE
    n_tiles = Wo_pad // LANE

    # ---- pass 1: vertical taps along the preimage curves ----
    ys = _curve_y_at_cols(cam_matrix, dist_coeffs, M, src_size, dst_size)
    valid = np.isfinite(ys)
    ys_safe = np.where(valid, ys, 0.0)
    y0 = np.floor(ys_safe)
    fy = (ys_safe - y0).astype(np.float32)
    # Per-tap validity, then remap onto the CLIPPED 2-slot window (an
    # edge pair keeps its in-bounds tap in the matching slot).
    w_tap0 = np.where(valid & (y0 >= 0) & (y0 <= Hs - 1), 1.0 - fy, 0.0)
    w_tap1 = np.where(valid & (y0 + 1 >= 0) & (y0 + 1 <= Hs - 1), fy, 0.0)
    w0 = np.where(y0 < 0, w_tap1, np.where(y0 > Hs - 2, 0.0, w_tap0))
    w1 = np.where(y0 < 0, 0.0, np.where(y0 > Hs - 2, w_tap0, w_tap1))
    y0c = np.clip(y0, 0, Hs - 2).astype(np.int64)
    xs = np.arange(Ws)[None, :]
    v_base = (y0c * Ws + xs).astype(np.int32)

    # ---- pass 2: horizontal taps from the exact fused grid ----
    gsx, _ = fused_undistort_warp_coords(
        cam_matrix, dist_coeffs, M, src_size, dst_size)
    # Pad columns edge-replicate the coordinate but never carry weight.
    sx = np.concatenate(
        [gsx, np.repeat(gsx[:, -1:], Wo_pad - Wo, axis=1)], axis=1)
    finx = np.isfinite(sx)
    finx[:, Wo:] = False
    sx_safe = np.where(np.isfinite(sx), sx, 0.0)
    x0 = np.floor(sx_safe)
    fx = (sx_safe - x0).astype(np.float32)
    h_tap0 = np.where(finx & (x0 >= 0) & (x0 <= Ws - 1), 1.0 - fx, 0.0)
    h_tap1 = np.where(finx & (x0 + 1 >= 0) & (x0 + 1 <= Ws - 1), fx, 0.0)
    hw0 = np.where(x0 < 0, h_tap1, np.where(x0 > Ws - 2, 0.0, h_tap0))
    hw1 = np.where(x0 < 0, 0.0, np.where(x0 > Ws - 2, h_tap0, h_tap1))
    x0c = np.clip(x0, 0, Ws - 2).astype(np.int64)

    # Per-(z, tile) band start, LANE-aligned, as the TPU kernel DMAs it,
    # with the reference's check that the band covers every tile's taps.
    tile_base = np.zeros((Ho, n_tiles), np.int64)
    for j in range(n_tiles):
        seg = x0c[:, j * LANE:(j + 1) * LANE]
        lo = (seg.min(axis=1) // LANE) * LANE
        hi = seg.max(axis=1) + 1
        if int((hi - lo).max()) + 1 > band:
            raise ValueError(
                f"band {band} too small: needs {(hi - lo).max() + 1}")
        tile_base[:, j] = np.clip(lo, 0, max(Ws_pad - band, 0))

    wpack = np.zeros((Ho, n_tiles, 4, LANE), np.float32)
    wpack[:, :, 0, :] = x0c.reshape(Ho, n_tiles, LANE)
    wpack[:, :, 1, :] = hw0.reshape(Ho, n_tiles, LANE)
    wpack[:, :, 2, :] = hw1.reshape(Ho, n_tiles, LANE)
    return {
        "v_base": v_base,
        "v_w0": w0.astype(np.float32),
        "v_w1": w1.astype(np.float32),
        "wpack": wpack,
        "tile_base": tile_base.reshape(-1).astype(np.int32),
        "geom": (Ws, Hs, Wo, Ho, int(band)),
    }


def _pass2_on_cuda(t1: torch.Tensor, wpack: torch.Tensor, out_width: int
                   ) -> bool:
    """Validate pass 2's inputs; True for the CUDA kernel, False for the
    plain twin (both on the CPU)."""
    if t1.dtype != torch.float32 or t1.dim() != 4:
        raise ValueError(f"t1 must be (T, C, Ho, Ws) float32, got "
                         f"{tuple(t1.shape)} {t1.dtype}")
    if (wpack.dtype != torch.float32 or wpack.dim() != 4
            or wpack.shape[2:] != (4, LANE) or wpack.shape[0] != t1.shape[2]):
        raise ValueError(f"wpack must be (Ho, n_tiles, 4, {LANE}) float32 "
                         f"with Ho = {t1.shape[2]}, got "
                         f"{tuple(wpack.shape)} {wpack.dtype}")
    if not 1 <= out_width <= wpack.shape[1] * LANE:
        raise ValueError(f"out_width {out_width} outside the tiles' "
                         f"{wpack.shape[1] * LANE} columns")
    device = _one_device(t1, wpack)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not (t1.is_contiguous() and wpack.is_contiguous()):
        raise ValueError("CUDA kernel inputs must be contiguous")
    return True


def pass2_plain(t1: torch.Tensor, wpack: torch.Tensor,
                out_width: int) -> torch.Tensor:
    """Plain twin of ``pass2``."""
    T, C, Ho, _ = t1.shape
    # (x0, w0, w1), each (Ho, out_width), from the packed tiles.
    x0, w0, w1 = wpack.permute(2, 0, 1, 3).reshape(4, Ho, -1)[:3, :,
                                                               :out_width]
    idx = x0.long().expand(T, C, Ho, out_width)
    a = t1.gather(3, idx)
    b = t1.gather(3, idx + 1)
    acc = (b.double() * w1.double() + (a * w0).double()).float()
    return torch.round(acc).clamp_(0, 255).to(torch.uint8)


def pass2(t1: torch.Tensor, wpack: torch.Tensor,
          out_width: int) -> torch.Tensor:
    """Pass 2 of the banded warp: (T, C, Ho, out_width) uint8 from the
    (T, C, Ho, Ws) float32 pass-1 planes ``t1`` and the packed tiles
    ``wpack`` (Ho, n_tiles, 4, LANE) of [x0, w0, w1, 0] per output column:
    ``clip(rint(fma(t1[.., x0 + 1], w1, t1[.., x0] * w0)), 0, 255)``."""
    out_width = int(out_width)
    if not _pass2_on_cuda(t1, wpack, out_width):
        return pass2_plain(t1, wpack, out_width)
    T, C, Ho, Ws = t1.shape
    out = torch.empty((T, C, Ho, out_width), dtype=torch.uint8,
                      device=t1.device)
    _call(t1.device, load_library().lt_banded_pass2,
          t1.data_ptr(), wpack.data_ptr(), out.data_ptr(), T * C, Ho, Ws,
          out_width, wpack.shape[1])
    LAUNCHES["banded_pass2"] += 1
    return out


class MxuWarp2(nn.Module):
    """The banded warp as buffers: ``v_base`` (Ho, Ws) int32 flat source
    index of each pass-1 pair's upper tap, ``v_w0`` / ``v_w1`` (Ho, Ws)
    f32 pass-1 weights, ``wpack`` (Ho, n_tiles, 4, LANE) f32 pass-2 taps
    and weights, ``tile_base`` (Ho * n_tiles,) int32 band starts (the TPU
    kernel's DMA offsets; the two-tap kernel reads x0 directly and does
    not need them); ``geom`` = (Ws, Hs, Wo, Ho, band)."""

    def __init__(self, tables: dict, device=DEFAULT_DEVICE):
        super().__init__()
        device = entry_device(device)
        for name in ("v_base", "v_w0", "v_w1", "wpack", "tile_base"):
            self.register_buffer(
                name, torch.from_numpy(np.ascontiguousarray(tables[name]))
                .to(device))
        self.geom = tuple(int(v) for v in tables["geom"])

    @classmethod
    def build(cls, cam_matrix, dist_coeffs, M, src_size, dst_size,
              band: int = 640, device=DEFAULT_DEVICE) -> "MxuWarp2":
        """Host build from a calibration, with the buffers on ``device``
        (the card unless the caller passes ``device="cpu"``)."""
        device = entry_device(device)
        return cls(build_tables(cam_matrix, dist_coeffs, M, src_size,
                                dst_size, band), device)

    def pass1(self, imgs: torch.Tensor) -> torch.Tensor:
        """(T, C, Ho, Ws) float32 vertical lerps of a (T, C, Hs, Ws) uint8
        batch: ``t0 * v_w0 + t1 * v_w1`` of each column's tap pair."""
        Ws, Hs, _, Ho, _ = self.geom
        T, C = imgs.shape[:2]
        flat = imgs.reshape(T, C, Hs * Ws)
        base = self.v_base.reshape(-1)
        t0 = flat.index_select(2, base).float()
        t1 = flat.index_select(2, base + Ws).float()
        t = t0 * self.v_w0.reshape(-1) + t1 * self.v_w1.reshape(-1)
        return t.reshape(T, C, Ho, Ws)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """Warp a (2, Hs, Ws) uint8 channel pair or a (T, 2, Hs, Ws) batch
        to (..., 2, Ho, Wo) uint8."""
        if imgs.dim() == 3:
            return self(imgs[None])[0]
        Ws, Hs, Wo, Ho, _ = self.geom
        if imgs.dtype != torch.uint8 or tuple(imgs.shape[1:]) != (2, Hs, Ws):
            raise ValueError(f"expected (T, 2, {Hs}, {Ws}) uint8, got "
                             f"{tuple(imgs.shape)} {imgs.dtype}")
        return pass2(self.pass1(imgs.contiguous()), self.wpack, Wo)
