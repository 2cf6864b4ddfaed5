"""Share of the program's frames that the warp + LAB kernels warped
(counter ``lt.warp_lab.kernel_frames`` over ``lt.frames``): 1 where every
frame's warp + LAB-B ran in the hand-written kernels, less where the
PyTorch chain ran some.  Nothing where the program counts no kernel
frames (a program without the kernels) or ran no frame."""

from benchmark import program

NAME = "warp_lab_kernel_share"
UNIT = "share"
LAYER = "front half: warp + LAB"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(trace):
    s = program.stretch(trace)
    if s is None or "lt.warp_lab.kernel_frames" not in s["counters"]:
        return None
    return program.count_per_frame(trace, "lt.warp_lab.kernel_frames")
