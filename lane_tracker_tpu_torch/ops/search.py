"""Lane-pixel search: sliding window (blind) and band (warm start).

Port of lane_tracker_tpu/ops/search.py:98-481, with a leading batch axis
instead of vmap: ``sws_precompute`` and ``sliding_window_intervals`` take
(T, ...) tensors and the level scan is a Python loop over the ~26 levels
with T as the batch.  Every quirk the reference keeps (search.py:25-42)
is kept: the empty window on a negative Python-slice start, the wrapped
negative stop of ``conv[min:max]``, floor plateau midpoints at level 0 and
ceil above, the right side's drift reading the left side's current-level
state, ``int(mu * diff)`` truncation, and the abort after
``no_success_limit`` misses.  The standalone mask API
(``sliding_window_search``, ``band_search``; search.py:435-481) derives
the pixel masks the debug picture draws from the intervals, one frame at a
time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lane_tracker_tpu_torch.ops import f32
from lane_tracker_tpu_torch.tracker.config import SearchConfig


class SearchIntervals(NamedTuple):
    """Per-row x-intervals [lo, hi) of selected lane pixels, per side
    (leading batch axes allowed on every field)."""

    left_lo: torch.Tensor  # (..., H) i32
    left_hi: torch.Tensor
    left_valid: torch.Tensor  # (..., H) bool
    right_lo: torch.Tensor
    right_hi: torch.Tensor
    right_valid: torch.Tensor
    left_centroids: torch.Tensor  # (..., nlevels) i32
    right_centroids: torch.Tensor
    left_n_centroids: torch.Tensor  # (...) i32
    right_n_centroids: torch.Tensor
    # Binary columns [lo, hi) each level's conv reads touched (empty for
    # band); read by the 'corridor' exactness certificate.
    left_read_lo: torch.Tensor  # (..., nlevels) i32
    left_read_hi: torch.Tensor
    right_read_lo: torch.Tensor
    right_read_hi: torch.Tensor


class SearchResult(NamedTuple):
    """Selected lane pixels of one frame, as masks."""

    left_mask: torch.Tensor  # (H, W) bool
    right_mask: torch.Tensor  # (H, W) bool
    detected: torch.Tensor  # () bool — both sides collected >= 1 pixel
    left_centroids: torch.Tensor
    right_centroids: torch.Tensor
    left_n_centroids: torch.Tensor
    right_n_centroids: torch.Tensor


class SwsPrecomp(NamedTuple):
    """State-independent sliding-window tensors of a (T, H, W) batch."""

    left_c0: torch.Tensor  # (T,) i32 — initial centroid
    left_found0: torch.Tensor  # (T,) bool
    right_c0: torch.Tensor
    right_found0: torch.Tensor
    conv_all: torch.Tensor  # (T, nlevels, W+ww-1) i32


def _plateau_mid(vals: torch.Tensor, ceil_mode: bool) -> torch.Tensor:
    """Midpoint of the argmax plateau along the last axis (masked entries
    must be < 0)."""
    n = vals.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=vals.device)
    is_max = vals == vals.max(-1, keepdim=True).values
    first = torch.where(is_max, idx, n).min(-1).values
    last = torch.where(is_max, idx, -1).max(-1).values
    return (first + last + (1 if ceil_mode else 0)) // 2


def _full_conv_ones(sm: torch.Tensor, ww: int) -> torch.Tensor:
    """np.convolve(ones(ww), row) for every row of (..., W) int32."""
    W = sm.shape[-1]
    cs = torch.cumsum(sm, dim=-1, dtype=torch.int32)
    total = W + ww - 1
    pos = torch.arange(total, device=sm.device)
    hi = cs[..., pos.clamp(0, W - 1)]
    lo = torch.where(pos - ww < 0, 0, cs[..., (pos - ww).clamp(0, W - 1)])
    return hi - lo


def _initial_centroid(conv, any_input, offset, fallback, ww):
    mid = _plateau_mid(torch.where(any_input[..., None], conv, -1), False)
    centroid = mid - ww // 2 + offset
    return torch.where(any_input, centroid, fallback).to(torch.int32), any_input


def sws_nlevels(cfg: SearchConfig, H: int) -> int:
    return int((cfg.partial * (H - cfg.ignore_bottom)) / cfg.window_height)


def sws_precompute(binary: torch.Tensor, cfg: SearchConfig) -> SwsPrecomp:
    """All state-independent sliding-window tensors of a (T, H, W) batch."""
    T, H, W = binary.shape
    dev = binary.device
    ww = int(cfg.window_width)
    wh = int(cfg.window_height)
    ignore_bottom = int(cfg.ignore_bottom)
    ignore_sides = int(cfg.ignore_sides)
    img_height = H - ignore_bottom
    img_center = W // 2
    y_start = int((1 - cfg.start_slice) * img_height)
    nlevels = sws_nlevels(cfg, H)

    img = (binary > 0).to(torch.int32)
    col_sum = img[:, y_start:img_height, :].sum(1, dtype=torch.int32)
    if img_center - ignore_sides > 0:
        lslice = col_sum[:, ignore_sides:img_center]
        left_c0, left_found0 = _initial_centroid(
            _full_conv_ones(lslice, ww), (lslice > 0).any(-1), ignore_sides,
            int(W * 0.4), ww)
    else:
        left_c0 = torch.full((T,), int(W * 0.4), dtype=torch.int32, device=dev)
        left_found0 = torch.zeros((T,), dtype=torch.bool, device=dev)
    if (W - ignore_sides) - img_center > 0:
        rslice = col_sum[:, img_center:W - ignore_sides]
        right_c0, right_found0 = _initial_centroid(
            _full_conv_ones(rslice, ww), (rslice > 0).any(-1), img_center,
            int(W * 0.6), ww)
    else:
        right_c0 = torch.full((T,), int(W * 0.6), dtype=torch.int32, device=dev)
        right_found0 = torch.zeros((T,), dtype=torch.bool, device=dev)

    # Level l covers rows [img_height-(1+l)*wh, img_height-l*wh).
    n_eff = max(nlevels, 1)
    usable = (min(n_eff * wh, img_height) // wh) * wh
    flipped = img[:, :img_height].flip(1)
    band_sums = img.new_zeros((T, n_eff, W))
    band_sums[:, :usable // wh] = flipped[:, :usable].reshape(
        T, usable // wh, wh, W).sum(2, dtype=torch.int32)
    return SwsPrecomp(
        left_c0=left_c0,
        left_found0=left_found0,
        right_c0=right_c0,
        right_found0=right_found0,
        conv_all=_full_conv_ones(band_sums, ww),
    )


def sliding_window_intervals(pre: SwsPrecomp, cfg: SearchConfig, H: int,
                             W: int) -> SearchIntervals:
    """Run the centroid state machine over the levels; emit per-row
    intervals, batched over the leading axis of ``pre``."""
    dev = pre.conv_all.device
    T = pre.conv_all.shape[0]
    ww = int(cfg.window_width)
    wh = int(cfg.window_height)
    w2 = ww // 2
    img_height = H - int(cfg.ignore_bottom)
    nlevels = sws_nlevels(cfg, H)
    limit = int(cfg.no_success_limit)
    mu = f32(cfg.mu)
    sr = int(cfg.search_range)
    conv_len = W + ww - 1
    conv_idx = torch.arange(conv_len, dtype=torch.int32, device=dev)

    def side_update(conv, c, ns, rmin, rmax, diff, has_diff, other_diff,
                    other_has_diff, other_ns):
        active = ns < limit
        min_index = (c + rmin + w2).clamp(min=0)
        max_index = (c + rmax + w2).clamp(max=W)
        # Negative-stop Python slice wraparound quirk.
        max_index = torch.where(max_index < 0, conv_len + max_index, max_index)
        in_range = ((conv_idx >= min_index[:, None])
                    & (conv_idx < max_index[:, None]))
        found = active & (torch.where(in_range, conv, 0) > 0).any(-1)
        rel = torch.where(in_range, conv, -1)
        is_max = (rel == rel.max(-1, keepdim=True).values) & in_range
        first = torch.where(is_max, conv_idx, conv_len).min(-1).values - min_index
        last = torch.where(is_max, conv_idx, -1).max(-1).values - min_index
        new_c_found = (first + last + 1) // 2 + min_index - w2
        step = torch.trunc(mu * (new_c_found - c).float()).to(torch.int32)
        drift = torch.where(active & other_has_diff & (other_ns == 0),
                            other_diff, 0)
        new_c = torch.where(found, new_c_found, c + drift)
        new_ns = torch.where(found, 0, torch.where(active, ns + 1, ns))
        new_rmin = torch.where(found, rmin + step, rmin)
        new_rmax = torch.where(found, rmax + step, rmax)
        new_diff = torch.where(found, new_c_found - c, diff)
        rd_lo = torch.where(active, (min_index - (ww - 1)).clamp(0, W), W)
        rd_hi = torch.where(active, max_index.clamp(0, W), 0)
        return ((new_c, new_ns, new_rmin, new_rmax, new_diff, has_diff | found),
                (found, new_c, active, rd_lo, rd_hi))

    def i32(v):
        return torch.full((T,), v, dtype=torch.int32, device=dev)

    false = torch.zeros((T,), dtype=torch.bool, device=dev)
    true = torch.ones((T,), dtype=torch.bool, device=dev)
    lc, rc = pre.left_c0, pre.right_c0
    lns = rns = i32(0)
    lrmin = rrmin = i32(-sr)
    lrmax = rrmax = i32(sr)
    ldiff = rdiff = i32(0)
    lhas = rhas = false

    # Level-0 (seed) reads are the static histogram slices.
    ignore_sides = int(cfg.ignore_sides)
    img_center = W // 2
    l0 = ((ignore_sides, img_center) if img_center - ignore_sides > 0
          else (W, 0))
    r0 = ((img_center, W - ignore_sides)
          if (W - ignore_sides) - img_center > 0 else (W, 0))
    # Per level and side: (found, centroid, active, read_lo, read_hi).
    left = [(pre.left_found0, lc, true, i32(l0[0]), i32(l0[1]))]
    right = [(pre.right_found0, rc, true, i32(r0[0]), i32(r0[1]))]
    for level in range(1, nlevels):
        conv = pre.conv_all[:, level]
        (lc, lns, lrmin, lrmax, ldiff_new, lhas_new), lrec = side_update(
            conv, lc, lns, lrmin, lrmax, ldiff, lhas, rdiff, rhas, rns)
        # Right side sees the left side's CURRENT-level state.
        (rc, rns, rrmin, rrmax, rdiff, rhas), rrec = side_update(
            conv, rc, rns, rrmin, rrmax, rdiff, rhas, ldiff_new, lhas_new, lns)
        ldiff, lhas = ldiff_new, lhas_new
        left.append(lrec)
        right.append(rrec)
    lfound, lcent, lactive, lrd_lo, lrd_hi = (torch.stack(x, -1)
                                              for x in zip(*left))
    rfound, rcent, ractive, rrd_lo, rrd_hi = (torch.stack(x, -1)
                                              for x in zip(*right))

    # ---- Per-row intervals from per-level window decisions ----
    ys = torch.arange(H, device=dev)
    n_mask_levels = max(nlevels, 1)
    level_of_row = torch.div(img_height - 1 - ys, wh, rounding_mode="floor")
    row_valid = ((ys < img_height) & (level_of_row >= 0)
                 & (level_of_row < n_mask_levels))
    lvl = level_of_row.clamp(0, n_mask_levels - 1)

    def side_intervals(found, cent):
        c_r = cent[:, lvl]
        x_lo = c_r - w2
        f_r = found[:, lvl] & row_valid & (x_lo >= 0)
        return x_lo, torch.clamp(c_r + w2, max=W), f_r

    llo, lhi, lval = side_intervals(lfound, lcent)
    rlo, rhi, rval = side_intervals(rfound, rcent)

    def n_centroids(active):
        appended = active.sum(-1, dtype=torch.int32)
        return torch.where((~active).any(-1), appended - limit, appended)

    return SearchIntervals(
        left_lo=llo,
        left_hi=lhi,
        left_valid=lval,
        right_lo=rlo,
        right_hi=rhi,
        right_valid=rval,
        left_centroids=lcent,
        right_centroids=rcent,
        left_n_centroids=n_centroids(lactive),
        right_n_centroids=n_centroids(ractive),
        left_read_lo=lrd_lo,
        left_read_hi=lrd_hi,
        right_read_lo=rrd_lo,
        right_read_hi=rrd_hi,
    )


def band_intervals(left_coeffs: torch.Tensor, right_coeffs: torch.Tensor,
                   cfg: SearchConfig, H: int, W: int) -> SearchIntervals:
    """Warm-start band intervals around the previous fit (3,) coefficients:
    integer x with poly - bw < x < poly + bw."""
    dev = left_coeffs.device
    bw = f32(cfg.bandwidth)
    top_cut = int(H * (1 - cfg.partial))
    rows = torch.arange(H, device=dev)
    ys = rows.float()
    row_ok = (rows >= top_cut) & (rows < H - int(cfg.ignore_bottom))

    def side(coeffs):
        c = coeffs.float()
        px = c[0] * ys * ys + c[1] * ys + c[2]
        # Saturate before the int cast, as XLA's f32 -> s32 convert does.
        lo = torch.floor(px - bw).clamp(-2.0**30, 2.0**30).to(torch.int32) + 1
        hi = torch.ceil(px + bw).clamp(-2.0**30, 2.0**30).to(torch.int32)
        return lo.clamp(0, W), hi.clamp(0, W)

    llo, lhi = side(left_coeffs)
    rlo, rhi = side(right_coeffs)
    nlevels = max(sws_nlevels(cfg, H), 1)
    zeros = torch.zeros((nlevels,), dtype=torch.int32, device=dev)
    full_w = torch.full((nlevels,), W, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return SearchIntervals(
        left_lo=llo,
        left_hi=lhi,
        left_valid=row_ok,
        right_lo=rlo,
        right_hi=rhi,
        right_valid=row_ok,
        left_centroids=zeros,
        right_centroids=zeros,
        left_n_centroids=zero,
        right_n_centroids=zero,
        # Band reads exactly its row intervals; no level reads.
        left_read_lo=full_w,
        left_read_hi=zeros,
        right_read_lo=full_w,
        right_read_hi=zeros,
    )


def intervals_to_masks(binary: torch.Tensor, iv: SearchIntervals):
    """Exact (H, W) pixel masks of one frame's per-row intervals."""
    nz = binary > 0
    xs = torch.arange(binary.shape[-1], device=binary.device)[None, :]

    def side(lo, hi, valid):
        return (nz & valid[:, None] & (xs >= lo[:, None])
                & (xs < hi[:, None]))

    return (side(iv.left_lo, iv.left_hi, iv.left_valid),
            side(iv.right_lo, iv.right_hi, iv.right_valid))


def _result_from_intervals(binary: torch.Tensor,
                           iv: SearchIntervals) -> SearchResult:
    left_mask, right_mask = intervals_to_masks(binary, iv)
    return SearchResult(
        left_mask=left_mask,
        right_mask=right_mask,
        detected=left_mask.any() & right_mask.any(),
        left_centroids=iv.left_centroids,
        right_centroids=iv.right_centroids,
        left_n_centroids=iv.left_n_centroids,
        right_n_centroids=iv.right_n_centroids,
    )


def sliding_window_search(binary: torch.Tensor,
                          cfg: SearchConfig) -> SearchResult:
    """Blind sliding-window search of one (H, W) binary, as masks."""
    H, W = binary.shape
    iv = sliding_window_intervals(sws_precompute(binary[None], cfg), cfg, H,
                                  W)
    return _result_from_intervals(binary, SearchIntervals(*(f[0] for f in iv)))


def band_search(binary: torch.Tensor, left_coeffs, right_coeffs,
                cfg: SearchConfig) -> SearchResult:
    """Warm-start band search of one (H, W) binary around (3,)
    coefficients, as masks."""
    H, W = binary.shape
    iv = band_intervals(left_coeffs, right_coeffs, cfg, H, W)
    return _result_from_intervals(binary, iv)
