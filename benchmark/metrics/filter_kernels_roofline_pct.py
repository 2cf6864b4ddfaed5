"""The filter library's kernels' share of their roofline: the least time of
the filter calls they ran (attempt 1's, two tophat launches a call; the
second attempt's, two adaptive-mean launches a call; at the cell's shapes,
benchmark/roofline.py) over the device time of every launch of those
kernels in the traced stretch."""

import collections

from benchmark import roofline
from benchmark import trace as tr

NAME = "filter_kernels_roofline_pct"
UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    if not trace.hand:
        return None
    s = trace.shapes
    n = collections.Counter(tr.hand_kernel_name(e) for e in trace.hand)
    least = (n["tophat_kernel"] / 2 * roofline.attempt1_filter_s(
        s["frames_per_call"], s["H"], s["W"], s["filter"])
        + n["adaptive_mean_kernel"] / 2 * roofline.second_filter_s(
            s["frames_per_call"], s["H"], s["W"], s["second_open_k"]))
    seconds = sum(e["dur"] for e in trace.hand) / 1e6
    if seconds <= 0.0:
        return None
    return 100.0 * least / seconds
