"""Share of the back half's frames that the back-half kernel scanned
(counter ``lt.back_half.kernel_frames`` over ``lt.back_half.frames``): 1
where every scan ran as one launch of the kernel, less where the
per-frame loop ran some.  Nothing where the program counts no kernel
frames (a program without the kernel) or scanned no frame."""

from benchmark import program

NAME = "back_half_kernel_share"
UNIT = "share"
LAYER = "back half"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(trace):
    s = program.stretch(trace)
    if s is None or "lt.back_half.kernel_frames" not in s["counters"]:
        return None
    kernel = program.count_per_frame(trace, "lt.back_half.kernel_frames")
    frames = program.count_per_frame(trace, "lt.back_half.frames")
    if kernel is None or not frames:
        return None
    return kernel / frames
