"""Host time inside the embed + sliding-window search stage
(``lt.embed_search``) a frame of the traced stretch."""

NAME = "embed_search_host_ms_per_frame"
UNIT = "ms"
LAYER = "front half: embed + search"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return trace.per_frame("lt.embed_search", "host_ms")
