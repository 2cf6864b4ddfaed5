"""The filter chain's vertical reach, and the corridor's column margin.

``filter_reach`` is how many rows above or below a binary row the filter
reads from its channels.  Held on the CPU, on the filters' plain twins:

* the reach of demo1's attempt 1 (93) and of the second attempt (21);
* the reach is needed: on a crafted LAB-B (a 54-row bright plateau ending
  35 rows above a faint 5-row bar at a band's edge, one dark row beyond
  the plateau), filtering the band's rows plus ``filter_reach`` rows
  beyond gives the full frame's rows, and one row fewer changes the
  band's edge row, at the top and at the bottom;
* along the columns, the same profile shows the corridor's 80-column
  compute margin (``tracker.step.CORRIDOR_MARGIN``, the JAX package's)
  below the reach: it changes a kept column.
"""

import pytest
import torch

from lane_tracker_tpu_torch.ops.filters import filter_stage
from lane_tracker_tpu_torch.ops.morphology import ellipse_runs
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.config import (
    PRESETS,
    SECOND_ATTEMPT,
    FilterConfig,
)

CFG = PRESETS["demo1"]


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


def test_reach_of_the_presets():
    """demo1's attempt 1: LAB-B's tophat 2 * 27 + cross arm 35 + open
    2 * 2; the second attempt: the k=35 box's 17 + 4."""
    assert filter_reach(CFG.filter) == 93
    assert filter_reach(SECOND_ATTEMPT.filter) == 21


def crafted_channels(H=300, W=256, a=150):
    """(R, LAB-B) of one frame whose binary row ``a`` depends on LAB-B row
    a - 93 and on nothing farther: a dark row a - 93, a 200 plateau on
    rows a-92 .. a-39 (54 rows: the k=55 opening removes it, so its bottom
    row's tophat enters row a-4's up arm), then 8 on row a-4 (it passes
    the cross threshold only while that arm holds no plateau) and 10 on
    rows a-3 .. a (they pass; with row a-4 the 5 x 5 open keeps the five
    rows, without it none).  R is black, LAB-B below 140 keeps the noise
    mask open."""
    b = torch.zeros(1, H, W, dtype=torch.uint8)
    b[0, a - 92:a - 38] = 200
    b[0, a - 4] = 8
    b[0, a - 3:a + 1] = 10
    return torch.zeros_like(b), b


def band_rows(r_ext, b_ext, f, lo, hi):
    """Rows [lo, hi) of the filter's binary and packed row prefixes of a
    band's channels extended beyond its own rows."""
    binary, pref = filter_stage(r_ext, b_ext, f)
    return binary[:, lo:hi], pref.packed[:, lo:hi]


@pytest.mark.parametrize("edge", ["top", "bottom"])
def test_halo_one_row_short_changes_the_band_edge(edge):
    f = CFG.filter
    reach = filter_reach(f)
    H, a = 300, 150
    r, b = crafted_channels(H, a=a)
    if edge == "bottom":  # the same profile upside down
        r, b = r.flip(1), b.flip(1)
    full, full_pref = filter_stage(r, b, f)
    for halo in (reach, reach - 1):
        if edge == "top":  # the band [a, H), its halo above
            e0 = a - halo
            got, pref = band_rows(r[:, e0:], b[:, e0:], f, a - e0, H - e0)
            want, want_pref, edge_row = full[:, a:], full_pref.packed[:, a:], 0
        else:  # the band [0, H - a), its halo below
            e1 = H - a + halo
            got, pref = band_rows(r[:, :e1], b[:, :e1], f, 0, H - a)
            want = full[:, :H - a]
            want_pref, edge_row = full_pref.packed[:, :H - a], H - a - 1
        differ = sorted({int(y) for y in (got != want).nonzero()[:, 1]})
        if halo == reach:
            assert differ == []
            assert torch.equal(pref, want_pref)
        else:
            assert differ == [edge_row], differ


def test_corridor_margin_is_below_the_filter_reach():
    """The reach holds along the columns too.  'corridor' computes the
    warped columns [x0 - 80, x1 + 80) (``CORRIDOR_MARGIN``, the JAX
    package's margin, sized by a reach of 75) and keeps [x0, x1): the
    crafted profile laid along the columns changes the first kept column,
    which a margin of ``filter_reach`` (93) keeps exact.  The port equals
    JAX's corridor, margin included (ROADMAP queue 3)."""
    f = CFG.filter
    r, b = (x.transpose(1, 2).contiguous() for x in crafted_channels())
    x0 = 150
    full, _ = filter_stage(r, b, f)
    for margin, differ in ((t_step.CORRIDOR_MARGIN, [0]),
                           (filter_reach(f), [])):
        c0 = x0 - margin
        win, _ = filter_stage(r[..., c0:].contiguous(),
                              b[..., c0:].contiguous(), f)
        d = (win[..., margin:] != full[..., x0:]).nonzero()[:, 2]
        assert sorted(set(d.tolist())) == differ, margin
