"""The front half of a chunk split by warped rows over devices.

Counterpart of handing the JAX package's chunk processor frames sharded
over the 'rows' axis of ``stream_row_mesh`` (lane_tracker_tpu/parallel/
mesh.py:27; tests/test_parallel.py:163-188), where XLA SPMD inserts the
halo exchanges the stencils need.  Here no collective runs: each band
recomputes its halo instead of exchanging it.  Band i of the warped rows
[a_i, b_i), on ``row_devices[i]``:

* runs the front half's row-local stages (``tracker.step.front_rows``:
  the warp + LAB, the attempt-1 filter and, with ``hoist_second_attempt``,
  the attempt-2 filter) on its rows plus ``halo`` rows above and below,
  clamped only at the frame's true top and bottom (its grids are those
  rows of the frame's grids, ``ResampleGrid.band``, reading only the raw
  rows they need; 'turbo''s fill bias those rows of the bias; in the
  latency mode each band grid's own tile structure, ``build_rowmm``);
* keeps its own rows of the channels, the binaries and the packed row
  prefixes (a row's prefixes read only that row).

The bands are assembled on ``row_devices[0]``, where the stages over
whole frames run (``tracker.step.front_search``: the corridor embedding
and the sliding-window search, which sums columns over many rows).  The
unsharded ``front_artifacts_batch`` runs the same two functions, so the
list of stages lives in one place.

The halo is the filter chain's vertical reach (``filter_reach``): a
binary row depends only on the channel rows within that many rows of it,
so a band's own rows come out exact whatever lies beyond its extended
rows, and the artifacts equal ``front_artifacts_batch``'s bit for bit.
Devices may repeat: several bands on one card is how the card checks it.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from lane_tracker_tpu_torch.kernels.resample_rowmm import build_rowmm
from lane_tracker_tpu_torch.ops.morphology import ellipse_runs
from lane_tracker_tpu_torch.tracker.config import FilterConfig, TrackerConfig
from lane_tracker_tpu_torch.tracker.step import (
    FrontArtifacts,
    FrontRows,
    TrackerParams,
    WarpChain,
    front_rows,
    front_search,
    hoisted_filter,
    warp_chain,
)


def _ellipse_reach(k: int) -> int:
    """Rows the k x k ellipse reaches from its anchor, up or down."""
    return max(abs(dy) for dy, _ in ellipse_runs(int(k)))


def filter_reach(f: FilterConfig) -> int:
    """Rows above or below a binary row that the filter ``f`` reads from
    its channels: the open's erode + dilate on the merge of the channel
    branches, each branch the longest of its stencils in sequence.

    * 'bilateral': the tophat's erode + dilate then the cross threshold's
      arm of ksize rows (each arm sums ksize pixels beyond the centre),
      on R and on LAB-B; the noise keep-mask a cross threshold of the raw
      LAB-B.
    * 'neighborhood': the adaptive means' boxes of radius (ksize - 1) / 2,
      and the same noise keep-mask.

    demo1's attempt 1 reaches 93 rows: LAB-B's 2 * 27 + 35, then the
    5 x 5 open's 2 * 2."""
    if f.filter_type == "neighborhood":
        branches = [(f.ksize_r - 1) // 2, (f.ksize_b - 1) // 2]
    else:
        branches = [2 * _ellipse_reach(f.tophat_r) + f.ksize_r,
                    2 * _ellipse_reach(f.tophat_b) + f.ksize_b]
    if f.mask_noise:
        branches.append(f.ksize_noise)
    return max(branches) + 2 * _ellipse_reach(f.open_k)


def front_halo(config: TrackerConfig, hoist_second_attempt: bool,
               params: TrackerParams) -> int:
    """The rows a band computes beyond its own, above and below: the
    attempt-1 filter's reach, and the second attempt's (``params``', the
    halved set for 'half') where it is hoisted into the front half."""
    second = hoisted_filter(params, config, hoist_second_attempt)
    halo = filter_reach(config.filter)
    return halo if second is None else max(halo, filter_reach(second))


def row_bounds(H: int, n: int) -> list[tuple[int, int]]:
    """n bands of H rows, as even as integers allow."""
    if not 1 <= n <= H:
        raise ValueError(f"{n} bands of {H} rows")
    return [(i * H // n, (i + 1) * H // n) for i in range(n)]


class Band(NamedTuple):
    """One band's share of the front half."""

    device: torch.device
    rows: tuple[int, int]  # its own warped rows [a, b)
    keep: tuple[int, int]  # those rows within its extended rows
    raw: tuple[int, int]  # the raw frame rows its grids read
    chain: WarpChain  # the resample of its extended rows, on its device


def _band_rowmm(grid, full, device):
    """A band grid's own tile structure, on ``device``, where the frame's
    grid has one (``full``), else None."""
    built = None if full is None else build_rowmm(grid)
    return None if built is None else built.to(device)


_PLANS: "weakref.WeakKeyDictionary[TrackerParams, dict]" = (
    weakref.WeakKeyDictionary())


def row_plan(params: TrackerParams, row_devices, halo: int) -> tuple:
    """The bands of ``params``' warped rows over ``row_devices`` with
    ``halo`` rows beyond each, their resample chains on their devices;
    cached per params, devices and halo (the grids' rows are read on the
    host once)."""
    devices = tuple(torch.device(d) for d in row_devices)
    plans = _PLANS.setdefault(params, {})
    key = (devices, int(halo))
    if key in plans:
        return plans[key]
    chain = warp_chain(params)
    H, W = chain.g_warp.dst_shape
    bands = []
    for dev, (a, b) in zip(devices, row_bounds(H, len(devices))):
        ea, eb = max(0, a - halo), min(H, b + halo)
        warp_band, (u0, u1) = chain.g_warp.band(ea, eb)
        und_band, (r0, r1) = chain.g_und.band(u0, u1)
        bias = (None if chain.bias is None
                else chain.bias[ea * W:eb * W].to(dev))
        band_chain = chain._replace(
            g_und=und_band.to(dev), g_warp=warp_band.to(dev), raw0=0,
            bias=bias, mm_und=_band_rowmm(und_band, chain.mm_und, dev),
            mm_warp=_band_rowmm(warp_band, chain.mm_warp, dev))
        bands.append(Band(dev, (a, b), (a - ea, b - ea),
                          (chain.raw0 + r0, chain.raw0 + r1), band_chain))
    plans[key] = tuple(bands)
    return plans[key]


def front_artifacts_rows(frames: torch.Tensor, params: TrackerParams,
                         config: TrackerConfig, row_devices,
                         hoist_second_attempt: bool = False
                         ) -> FrontArtifacts:
    """``front_artifacts_batch`` of a (T, Hc, Wc, 3) uint8 chunk with the
    warped rows split over ``row_devices`` (module docstring); the
    artifacts on ``row_devices[0]``, which holds ``params``."""
    second = hoisted_filter(params, config, hoist_second_attempt)
    halo = front_halo(config, hoist_second_attempt, params)
    dev0 = torch.device(row_devices[0])
    parts = []
    for band in row_plan(params, row_devices, halo):
        raw = frames[:, band.raw[0]:band.raw[1]].to(band.device)
        ext = front_rows(raw, band.chain, config, second)
        lo, hi = band.keep
        parts.append([None if x is None else x[:, lo:hi].to(dev0)
                      for x in ext])
    own = FrontRows(*(None if xs[0] is None else torch.cat(xs, dim=1)
                      for xs in zip(*parts)))
    return front_search(own, params, config)
