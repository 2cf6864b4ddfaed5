# Frozen copy of lane_tracker_tpu_torch/render/lane.py:1-115 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
"""Lane overlays: direct in camera space, or unwarped from a mask.

Port of lane_tracker_tpu/render/lane.py:22-149, batched over a leading
frame axis.  ``forward_bv_grid`` is copied from there (host numpy).

* ``lane_overlay_direct`` ('fast', 'corridor') tests every camera pixel's
  precomputed bird's-eye coordinates against the smoothed boundary
  polynomials and adds 0.3*255 of green over the lane region, with a
  one-BV-pixel linear ramp at the edges.
* ``lane_region_mask`` + ``lane_overlay`` ('compat', the reference's
  draw_lane): the region between the two re-anchored graphs as a
  bird's-eye 0/255 mask, unwarped to the camera through the float grid of
  ``Minv`` and added as ``rint(0.3 * g)`` of green with saturation
  (``cv2.addWeighted(img, 1, lane, 0.3, 0)``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.resample import (
    ResampleGrid,
    bilinear_gather,
)
from benchmark.reference.util import f32


def forward_bv_grid(M, img_size, warped_size):
    """Host precompute: each camera pixel's bird's-eye coordinates,
    Minv^-1 @ p = M @ p.  Returns float32 (Hc, Wc) u and v arrays."""
    Wc, Hc = int(img_size[0]), int(img_size[1])
    Mf = np.asarray(M, dtype=np.float64)
    xs = np.arange(Wc, dtype=np.float64)
    ys = np.arange(Hc, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys)
    w = Mf[2, 0] * X + Mf[2, 1] * Y + Mf[2, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_w = np.where(np.abs(w) > 1e-12, 1.0 / w, 0.0)
    u = (Mf[0, 0] * X + Mf[0, 1] * Y + Mf[0, 2]) * inv_w
    v = (Mf[1, 0] * X + Mf[1, 1] * Y + Mf[1, 2]) * inv_w
    return u.astype(np.float32), v.astype(np.float32)


def lane_overlay_direct(frames, left_coeffs, right_coeffs, n_left, n_right,
                        first_left, first_right, u_grid, v_grid, warped_size,
                        ploty_start: float, ploty_step: float, enable):
    """Blend the lane region onto (T, Hc, Wc, 3) uint8 frames.

    Per-frame inputs carry a leading T axis: coefficients (T, 3); counts,
    first indices and ``enable`` (T,).  The re-anchored graph lookup
    fitx[first + v - (H - n)] is evaluated as polyval at the affine ploty
    position."""
    H = int(warped_size[1])
    v = v_grid[None]
    start = f32(ploty_start)
    step = f32(ploty_step)

    def boundary(coeffs, n, first):
        n_f = n.float()[:, None, None]
        idx = first.float()[:, None, None] + v - (H - n_f)
        y = start + step * idx
        c = coeffs.float()[:, :, None, None]
        x = torch.trunc(c[:, 0] * y * y + c[:, 1] * y + c[:, 2])
        return x, v >= (H - n_f)

    xl, lhas = boundary(left_coeffs, n_left, first_left)
    xr, rhas = boundary(right_coeffs, n_right, first_right)
    row_ok = lhas & rhas & (v <= H - 1) & (v >= 0)
    u = u_grid[None]
    cov = torch.clamp(torch.minimum(u - xl + 1.0, xr - u + 1.0), 0.0, 1.0)
    cov = cov * row_ok.float()
    add = torch.round(cov * f32(0.3 * 255.0)).to(torch.int32)
    add = torch.where(enable[:, None, None], add, 0)
    g = torch.clamp(frames[..., 1].to(torch.int32) + add, max=255)
    return torch.stack([frames[..., 0], g.to(torch.uint8), frames[..., 2]],
                       dim=-1)


def lane_region_mask(warped_size, fitx_left, fitx_right, n_left, n_right,
                     first_left, first_right) -> torch.Tensor:
    """(T, H, W) uint8 0/255 mask of the lane region between the graphs.

    Graphs are (T, m) samples re-anchored as poly_points_meta leaves them:
    row y >= H - n takes boundary x = fitx[first + y - (H - n)], truncated
    to int as the reference does before fillPoly; rows where either side
    has no sample stay empty."""
    W, H = int(warped_size[0]), int(warped_size[1])
    ys = torch.arange(H, device=fitx_left.device)

    def boundary(fitx, n, first):
        n = n.long()[:, None]
        idx = first.long()[:, None] + ys - (H - n)
        has = ys >= (H - n)
        x = torch.gather(fitx, 1, idx.clamp(0, fitx.shape[-1] - 1))
        return torch.trunc(x), has

    lx, lhas = boundary(fitx_left, n_left, first_left)
    rx, rhas = boundary(fitx_right, n_right, first_right)
    xs = torch.arange(W, dtype=torch.float32, device=fitx_left.device)
    inside = ((lhas & rhas)[..., None] & (xs >= lx[..., None])
              & (xs <= rx[..., None]))
    return torch.where(inside, 255, 0).to(torch.uint8)


def lane_overlay(frames: torch.Tensor, lane_mask: torch.Tensor,
                 unwarp_grid: ResampleGrid, enable) -> torch.Tensor:
    """Add the unwarped (T, H, W) lane mask as green to (T, Hc, Wc, 3)
    uint8 frames; frames whose (T,) ``enable`` is False pass through."""
    green = bilinear_gather(lane_mask[..., None], unwarp_grid)[..., 0]
    add = torch.round(green.float() * f32(0.3)).to(torch.int32)
    add = torch.where(enable[:, None, None], add, 0)
    g = torch.clamp(frames[..., 1].to(torch.int32) + add, max=255)
    return torch.stack([frames[..., 0], g.to(torch.uint8), frames[..., 2]],
                       dim=-1)
