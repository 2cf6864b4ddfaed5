"""Device operations launched inside the back half (``lt.back_half``) a
frame of the traced stretch."""

NAME = "back_half_launches_per_frame"
UNIT = "launches/frame"
LAYER = "back half"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    return trace.per_frame("lt.back_half", "launches")
