"""Host time in the back half's update (``lt.back_half.update``: history,
smoothing, render geometry, radius, eccentricity and state) a frame of the
program stretch."""

from benchmark import program

NAME = "back_half_update_ms_per_frame"
UNIT = "ms"
LAYER = "back half"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return program.span_ms_per_frame(trace, "lt.back_half.update")
