"""Reads of a device value the host waited for (counter ``lt.host_reads``)
a frame of the program stretch."""

from benchmark import program

NAME = "host_reads_per_frame"
UNIT = "reads/frame"
LAYER = "back half"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(trace):
    return program.count_per_frame(trace, "lt.host_reads")
