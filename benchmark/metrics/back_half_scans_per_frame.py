"""Back-half scans a frame (counter ``lt.back_half.frames`` over
``lt.frames``): 1 where every frame is scanned once, 2 where two_phase
rescans every chunk."""

from benchmark import program

NAME = "back_half_scans_per_frame"
UNIT = "scans/frame"
LAYER = "back half"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(trace):
    return program.count_per_frame(trace, "lt.back_half.frames")
