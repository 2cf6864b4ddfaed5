"""Host time inside the second attempt's front (``lt.second_attempt``) a
frame of the traced stretch; nothing where it never ran."""

NAME = "second_attempt_host_ms_per_frame"
UNIT = "ms"
LAYER = "second attempt"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(trace):
    return trace.per_frame("lt.second_attempt", "host_ms")
