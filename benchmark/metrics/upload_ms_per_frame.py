"""Host time copying the chunk's frames to the card (``lt.upload``) a frame
of the program stretch."""

from benchmark import program

NAME = "upload_ms_per_frame"
UNIT = "ms"
LAYER = "entry"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return program.span_ms_per_frame(trace, "lt.upload")
