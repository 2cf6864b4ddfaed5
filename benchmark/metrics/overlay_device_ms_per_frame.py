"""Device time of the overlay (``lt.overlay``) a frame of the traced
stretch."""

NAME = "overlay_device_ms_per_frame"
UNIT = "ms"
LAYER = "overlay"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    return trace.per_frame("lt.overlay", "device_ms")
