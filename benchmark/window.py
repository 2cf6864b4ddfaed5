"""The measured window: whole chunks or steps over the whole time."""

from __future__ import annotations

import time


def run_window(unit, seconds: float, sync, clock=time.perf_counter) -> dict:
    """Run ``unit()`` (one chunk or step; returns the frames it took) until
    the first one that ends, after ``sync()``, ``seconds`` or more after
    the window opened.  Returns the units, the frames, the seconds from
    the window's opening to that last completion and each unit's
    seconds."""
    sync()
    start = clock()
    frames, units, ends = 0, 0, []
    while True:
        frames += int(unit())
        sync()
        units += 1
        ends.append(clock() - start)
        if ends[-1] >= seconds:
            break
    per_unit = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    return {"units": units, "frames": frames, "seconds": ends[-1],
            "unit_seconds": per_unit}


def frames_per_s(window: dict) -> float:
    """All frames completed over all of the window's time."""
    return window["frames"] / window["seconds"]
