"""Device time of the attempt-1 filter stage (``lt.filter``) a frame of the
traced stretch."""

NAME = "filter_device_ms_per_frame"
UNIT = "ms"
LAYER = "front half: filter"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    return trace.per_frame("lt.filter", "device_ms")
