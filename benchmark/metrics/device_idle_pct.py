"""The share of the traced stretch's wall time in which no kernel, copy or
set ran on the device."""

NAME = "device_idle_pct"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(trace):
    if trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
