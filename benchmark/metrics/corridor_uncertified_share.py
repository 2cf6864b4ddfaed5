"""Share of the corridor's frames whose decisions the certificate does not
vouch for (counter ``lt.corridor.uncertified`` over
``lt.corridor.frames``): 0 where every frame's reads stayed inside the
corridor, so that its decisions equal full-width 'fast''s.  Nothing where
the program counts no corridor frames (another pipeline, or a program
without the counter)."""

from benchmark import program

NAME = "corridor_uncertified_share"
UNIT = "share"
LAYER = "corridor"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(trace):
    s = program.stretch(trace)
    if s is None or not s["counters"].get("lt.corridor.frames"):
        return None
    return (s["counters"].get("lt.corridor.uncertified", 0)
            / s["counters"]["lt.corridor.frames"])
