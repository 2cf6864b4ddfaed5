"""Host time inside the back half (``lt.back_half``) a frame of the traced
stretch."""

NAME = "back_half_host_ms_per_frame"
UNIT = "ms"
LAYER = "back half"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return trace.per_frame("lt.back_half", "host_ms")
