"""Quadratic least squares, poly sampling, validity, radius, eccentricity.

Port of lane_tracker_tpu/ops/polyfit.py:35-235.  The fit consumes per-row
pixel counts and x-sums (from prefix-sum interval lookups), standardises y
by the data moments and solves the 3x3 normal equations in float32 with
the reference's arithmetic order.  The solve is written out (Gaussian
elimination with partial pivoting) so that it runs the same elementwise
float32 operations on the CPU and the card, with no library call and no
host synchronisation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from lane_tracker_tpu_torch.ops import f32
from lane_tracker_tpu_torch.tracker.config import ValidityConfig


def _solve3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 3, 3) @ x = (..., 3) by Gaussian elimination with
    partial pivoting (first maximal pivot on ties)."""
    A = torch.cat([M, b[..., None]], dim=-1)  # (..., 3, 4)
    rows = torch.arange(3, device=M.device)
    for col in range(3):
        piv = A[..., col:, col].abs().argmax(-1) + col  # (...)
        perm = torch.where(rows == col, piv[..., None],
                           torch.where(rows == piv[..., None], col, rows))
        A = torch.gather(A, -2, perm[..., None].expand(A.shape))
        pivot_row = A[..., col, :]
        below = [A[..., r, :] - (A[..., r, col] / A[..., col, col])[..., None]
                 * pivot_row for r in range(col + 1, 3)]
        A = torch.stack([A[..., r, :] for r in range(col + 1)] + below, dim=-2)
    x2 = A[..., 2, 3] / A[..., 2, 2]
    x1 = (A[..., 1, 3] - A[..., 1, 2] * x2) / A[..., 1, 1]
    x0 = (A[..., 0, 3] - A[..., 0, 1] * x1 - A[..., 0, 2] * x2) / A[..., 0, 0]
    return torch.stack([x0, x1, x2], dim=-1)


def fit_poly_mask(mask: torch.Tensor) -> torch.Tensor:
    """x = A y^2 + B y + C over the True (nonzero) pixels of an (..., H,
    W) mask -> (..., 3) float32 [A, B, C]: ``fit_poly_rows`` of its
    per-row counts and x-sums (exact in float32 below 2^24).  Undefined
    below 3 distinct rows, as the reference's; callers gate on detection."""
    w = (mask != 0).float()
    W = mask.shape[-1]
    xs = torch.arange(W, dtype=torch.float32, device=mask.device)
    return fit_poly_rows(w.sum(-1), (w * xs).sum(-1), W)


def fit_poly_rows(row_n: torch.Tensor, row_sx: torch.Tensor,
                  W: int) -> torch.Tensor:
    """x = A y^2 + B y + C from per-row counts and x-sums (..., H) ->
    (..., 3) float32 [A, B, C]."""
    H = row_n.shape[-1]
    row_n = row_n.float()
    row_sx = row_sx.float()
    ys = torch.arange(H, dtype=torch.float32, device=row_n.device)
    n = row_n.sum(-1)
    n_safe = n.clamp(min=1.0)

    # Standardize y by data moments for conditioning.
    my = (row_n * ys).sum(-1) / n_safe
    vy = (row_n * (ys * ys)).sum(-1) / n_safe - my * my
    sy = torch.sqrt(vy.clamp(min=f32(1e-12)))
    t = (ys - my[..., None]) / sy[..., None]

    # Center x (scale by W for magnitude only).
    mx = row_sx.sum(-1) / n_safe
    u_row = (row_sx - row_n * mx[..., None]) / W

    t2 = t * t
    S1 = (row_n * t).sum(-1)
    S2 = (row_n * t2).sum(-1)
    S3 = (row_n * (t2 * t)).sum(-1)
    S4 = (row_n * (t2 * t2)).sum(-1)
    P0 = u_row.sum(-1)
    P1 = (u_row * t).sum(-1)
    P2 = (u_row * t2).sum(-1)

    M = torch.stack([
        torch.stack([S4, S3, S2], dim=-1),
        torch.stack([S3, S2, S1], dim=-1),
        torch.stack([S2, S1, n], dim=-1),
    ], dim=-2)
    b = torch.stack([P2, P1, P0], dim=-1)
    # Fewer than 3 points: substitute the identity so the result stays
    # finite (callers gate on the detection flags).
    degenerate = n < 3.0
    M = torch.where(degenerate[..., None, None],
                    torch.eye(3, dtype=torch.float32, device=M.device), M)
    b = torch.where(degenerate[..., None], 0.0, b)
    abc = _solve3(M, b)
    a, bb, c = abc[..., 0], abc[..., 1], abc[..., 2]

    A = W * a / (sy * sy)
    B = W * (bb / sy - 2.0 * a * my / (sy * sy))
    C = W * (a * my * my / (sy * sy) - bb * my / sy + c) + mx
    return torch.stack([A, B, C], dim=-1)


class PolyPoints(NamedTuple):
    """Fixed-shape rendition of the reference's get_poly_points."""

    fitx: torch.Tensor  # (..., n_samples) f32 — x at each ploty sample
    inb: torch.Tensor  # (..., n_samples) bool — sample within [0, W-1]
    n: torch.Tensor  # (...) int32 — number of surviving samples
    first: torch.Tensor  # (...) int32 — index of the first survivor


def ploty_grid(warped_size, partial: float, device=None) -> torch.Tensor:
    """np.linspace(H*(1-partial), H-1, int(H*partial)) as float32, one
    shared read-only tensor per (H, partial, device): the back half asks
    for it every frame, and a copy from host memory to the card would
    wait for the card each time."""
    return _ploty(int(warped_size[1]), float(partial),
                  None if device is None else torch.device(device))


@functools.lru_cache(maxsize=16)
def _ploty(H: int, partial: float, device) -> torch.Tensor:
    num = int(H * partial)
    grid = np.linspace(H * (1.0 - partial), H - 1.0, num).astype(np.float32)
    return torch.as_tensor(grid, device=device)


def poly_points_meta(coeffs: torch.Tensor, ploty: torch.Tensor,
                     warped_size) -> PolyPoints:
    """Sample (..., 3) coefficients at ``ploty``; count the in-image run."""
    W = int(warped_size[0])
    c = coeffs.float()
    fitx = c[..., 0:1] * ploty * ploty + c[..., 1:2] * ploty + c[..., 2:3]
    inb = (fitx <= W - 1) & (fitx >= 0)
    m = ploty.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=ploty.device)
    return PolyPoints(
        fitx=fitx,
        inb=inb,
        n=inb.sum(-1, dtype=torch.int32),
        first=torch.where(inb, idx, m).min(-1).values,
    )


def check_validity(left_coeffs, right_coeffs, n_left, n_right, warped_size,
                   vcfg: ValidityConfig) -> torch.Tensor:
    """Two-stage plausibility test on a candidate pair; () bool.  Keeps the
    reference quirk of probing y from the warped WIDTH when
    ``vcfg.y_eval_from_width``."""
    W, H = int(warped_size[0]), int(warped_size[1])
    base = W if vcfg.y_eval_from_width else H
    y1 = float(base - 1)
    nmin = torch.minimum(n_left, n_right).float()
    y2 = float(base) - torch.trunc(nmin * f32(0.35))
    y3 = float(base) - torch.trunc(nmin * f32(0.75))
    lc = left_coeffs.float()
    rc = right_coeffs.float()

    def at(c, y):
        return c[0] * y * y + c[1] * y + c[2]

    def deriv(c, y):
        return 2.0 * c[0] * y + c[1]

    x1 = torch.abs(at(lc, y1) - at(rc, y1))
    x2 = torch.abs(at(lc, y2) - at(rc, y2))
    x3 = torch.abs(at(lc, y3) - at(rc, y3))
    dist_ok = ((x1 >= f32(vcfg.min_dist_y1)) & (x1 <= f32(vcfg.max_dist_y1))
               & (x2 >= f32(vcfg.min_dist_y2)) & (x2 <= f32(vcfg.max_dist_y2))
               & (x3 >= f32(vcfg.min_dist_y3)) & (x3 <= f32(vcfg.max_dist_y3)))
    n1 = torch.abs(deriv(lc, y1) - deriv(rc, y1))
    n2 = torch.abs(deriv(lc, y3) - deriv(rc, y3))
    thr = f32(vcfg.tangent_thresh)
    return dist_ok & (n1 < thr) & (n2 < thr)


def metric_coeffs(coeffs: torch.Tensor, mppv: float,
                  mpph: float) -> torch.Tensor:
    """The metric-space fit of a pixel-space one, (..., 3) -> (..., 3):
    [A mpph / mppv^2, B mpph / mppv, C mpph], the closed-form
    reparametrisation of the least squares (the reference's second
    np.polyfit, lane_tracker.py:534-535)."""
    return torch.stack([coeffs[..., 0] * f32(mpph) / f32(mppv * mppv),
                        coeffs[..., 1] * f32(mpph) / f32(mppv),
                        coeffs[..., 2] * f32(mpph)], dim=-1)


def curve_radius_m(coeffs: torch.Tensor, warped_size, mppv: float,
                   mpph: float) -> torch.Tensor:
    """Curve radius in meters at y_eval = warped height, truncated.  The
    metric fit's first two coefficients are ``metric_coeffs``', computed
    here without the stack: the back half that calls this is
    launch-bound."""
    m0 = coeffs[..., 0] * f32(mpph) / f32(mppv * mppv)
    m1 = coeffs[..., 1] * f32(mpph) / f32(mppv)
    y_eval = float(int(warped_size[1]))
    slope = 2.0 * m0 * y_eval * f32(mppv) + m1
    r = (1.0 + slope * slope) ** 1.5 / torch.abs(2.0 * m0)
    return torch.trunc(r)


def eccentricity_m(left_bottom_x, right_bottom_x, warped_size,
                   mpph: float) -> torch.Tensor:
    """Signed lane-center offset in meters from the bottom-most smoothed
    graph x values (already truncated)."""
    mid = float(int(warped_size[0]) // 2)
    dx1 = mid - left_bottom_x
    dx2 = right_bottom_x - mid
    return ((dx1 - dx2) / 2.0) * f32(mpph)
