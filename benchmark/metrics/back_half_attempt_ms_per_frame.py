"""Host time in the back half's attempts (``lt.back_half.attempt``: search
intervals, moments, fit and validity) a frame of the program stretch."""

from benchmark import program

NAME = "back_half_attempt_ms_per_frame"
UNIT = "ms"
LAYER = "back half"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return program.span_ms_per_frame(trace, "lt.back_half.attempt")
