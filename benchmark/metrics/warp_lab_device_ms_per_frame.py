"""Device time of the warp + LAB-B stage (``lt.warp_lab``) a frame of the traced stretch."""

NAME = "warp_lab_device_ms_per_frame"
UNIT = "ms"
LAYER = "front half: warp + LAB"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    return trace.per_frame("lt.warp_lab", "device_ms")
