"""Search-process visualization (debug path).

Port of lane_tracker_tpu/render/viz.py:1-131: equivalents of
``visualize_sliding_window_search`` and ``visualize_band_search``
(lane_tracker.py:688-771): the binary image with search windows / band
highlighted in green, detected lane pixels in red and blue, and the fitted
polynomial graph in yellow.  This path recomputes the search on demand
from the pre-step state; it is for debugging only and never touches the
hot loop.

The binary is the tracker's own: the frame's channels from
``warp_channels`` (the tracker's branch for its pipeline: 'turbo''s
reordered chain, as the reference's turbo branch, viz.py:28-34; the
latency mode's tile structures, bit for bit the gather), the port's
``filter_stage`` (the kernels on the card, their plain versions on the
CPU) and, in 'corridor', the corridor embedding the tracker searches.
In 'half' that is the halved filter: the config's halved structuring
elements and, after a second attempt, ``SECOND_ATTEMPT_HALF``; the
reference's picture filters with the full-size elements there (its
viz.py:68-82 passes none) and ``SECOND_ATTEMPT``, a binary its tracker
did not search.  The drawing is host numpy, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.ops.polyfit import ploty_grid, poly_points_meta
from lane_tracker_tpu_torch.ops.search import band_search, sliding_window_search
from lane_tracker_tpu_torch.tracker.step import (
    _embed_cols,
    _sa_config,
    warp_channels,
)


def _poly_graph_points(coeffs, warped_size, partial=1.0):
    ploty = ploty_grid(warped_size, partial)
    meta = poly_points_meta(torch.as_tensor(np.asarray(coeffs, np.float32)),
                            ploty, warped_size)
    n = int(meta.n)
    first = int(meta.first)
    H = int(warped_size[1])
    fitx = meta.fitx.numpy()
    ys = np.arange(H - n, H)
    xs = fitx[first : first + n].astype(int)
    return ys, xs


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def search_visualization(tracker, frame: torch.Tensor, config, out):
    """Rebuild the search picture for the frame just processed; ``frame``
    is the (Hc, Wc, 3) uint8 tensor the tracker processed."""
    params = tracker.params
    state = tracker._prev_state if tracker._prev_state is not None else tracker._state
    W, H = params.warped_size
    # Reproduce the binary input of the attempt that produced the result.
    cfg = config if int(out.n_attempts) == 1 else _sa_config(params)
    r, b = warp_channels(frame[None], params)
    binary_t = _embed_cols(filter_stage(r, b, cfg.filter)[0], params)[0]
    scfg = cfg.search
    binary = _host(binary_t)
    output = np.repeat(binary[..., None], 3, axis=2)

    if not bool(out.detected):
        # No lane pixels anywhere: the reference visualizes the bare binary
        # image of the last attempt instead of a search overlay
        # (lane_tracker.py:1130-1137; returned 3-channel here because every
        # viz output of this module is RGB).
        return output

    if int(out.search_mode) == 0:  # sliding window
        res = sliding_window_search(binary_t, scfg)
        wh, ww = scfg.window_height, scfg.window_width
        img_height = H - scfg.ignore_bottom
        windows = np.zeros((H, W), bool)
        for side in ("left", "right"):
            cents = _host(getattr(res, f"{side}_centroids"))
            n_c = int(getattr(res, f"{side}_n_centroids"))
            for level in range(max(n_c, 0)):
                c = int(cents[level])
                y0 = max(img_height - (level + 1) * wh, 0)
                y1 = img_height - level * wh
                x0 = max(c - ww // 2, 0)
                x1 = min(c + ww // 2, W)
                if x1 > x0:
                    windows[y0:y1, x0:x1] = True
        # Green half-intensity windows over the binary (addWeighted 0.5).
        output[windows, 1] = np.minimum(output[windows, 1].astype(int) + 127, 255)
    else:  # band search around the previous fit
        res = band_search(binary_t, state.last_left, state.last_right, scfg)
        bw = scfg.bandwidth
        for coeffs in (_host(state.last_left), _host(state.last_right)):
            ys, xs = _poly_graph_points(coeffs, params.warped_size, scfg.partial)
            for dx in range(-bw, bw + 1):
                xs_b = np.clip(xs + dx, 0, W - 1)
                output[ys, xs_b, 1] = np.minimum(
                    output[ys, xs_b, 1].astype(int) + 76, 255
                )

    lm = _host(res.left_mask)
    rm = _host(res.right_mask)
    output[lm] = [255, 0, 0]
    output[rm] = [0, 0, 255]

    for coeffs in (_host(out.left_coeffs), _host(out.right_coeffs)):
        ys, xs = _poly_graph_points(coeffs, params.warped_size)
        output[ys, np.clip(xs, 0, W - 1)] = [255, 235, 0]
    return output
