"""Share of the chunk's frames that reached the card through the pinned
slices of ``LaneTracker.process_chunk`` (counter
``lt.upload.streamed_frames`` over ``lt.frames``): 1 where every frame
streamed up under the warp, 0 where none did.  Nothing where the program
counts no streamed frames (a program without the streamed upload) or ran
no frame."""

from benchmark import program

NAME = "upload_streamed_share"
UNIT = "share"
LAYER = "entry"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(trace):
    s = program.stretch(trace)
    if s is None or "lt.upload.streamed_frames" not in s["counters"]:
        return None
    return program.count_per_frame(trace, "lt.upload.streamed_frames")
