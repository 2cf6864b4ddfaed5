"""Host time inside the back half (``lt.back_half`` spans) a frame of the
program stretch, with the profiler off (benchmark/program.py)."""

from benchmark import program

NAME = "back_half_span_ms_per_frame"
UNIT = "ms"
LAYER = "back half"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return program.span_ms_per_frame(trace, "lt.back_half")
