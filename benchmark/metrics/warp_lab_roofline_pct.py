"""The warp + LAB-B stage's share of its roofline: the least time of its work
(the raw rows the warp samples read once, the R and LAB-B planes written
once, at the HBM rate; benchmark/roofline.py) over the stage's device time."""

from benchmark import roofline

NAME = "warp_lab_roofline_pct"
UNIT = "%"
LAYER = "front half: warp + LAB"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    ms = trace.stages["lt.warp_lab"]["device_ms"]
    if ms <= 0.0:
        return None
    s = trace.shapes
    least = roofline.warp_lab_s(trace.frames, s["raw_rows"], s["raw_width"],
                                s["H"], s["W"])
    return 100.0 * least * 1e3 / ms
