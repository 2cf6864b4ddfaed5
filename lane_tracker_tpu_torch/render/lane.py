"""Lane overlay rendered directly in camera space.

Port of lane_tracker_tpu/render/lane.py:60-128.  ``forward_bv_grid`` is
copied from there (host numpy).  ``lane_overlay_direct`` tests every
camera pixel's precomputed bird's-eye coordinates against the smoothed
boundary polynomials and adds 0.3*255 of green over the lane region, with
a one-BV-pixel linear ramp at the edges (the reference's addWeighted of
the unwarped lane mask).  Batched over a leading frame axis.
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.ops import f32


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
