"""Host time embedding each attempt's compute-window binary and prefixes
onto the full warped width (``lt.corridor.embed``) a frame of the program
stretch; nothing where the pipeline has no corridor or the program opens
no such span."""

from benchmark import program

NAME = "corridor_embed_ms_per_frame"
UNIT = "ms"
LAYER = "corridor"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return program.span_ms_per_frame(trace, "lt.corridor.embed")
