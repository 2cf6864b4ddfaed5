"""The window counts whole chunks over the whole time."""

import pytest

from benchmark import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations,seconds,units", [
    ([10.0] * 6, 40.0, 4),
    ([10.0, 12.0, 9.0, 11.0, 10.0], 40.0, 4),
    ([3.0] * 20, 10.0, 4),
    ([50.0], 10.0, 1),
])
def test_whole_units_until_one_ends_past_the_window(durations, seconds,
                                                   units):
    clock = Clock()
    it = iter(durations)

    def unit():
        clock.t += next(it)
        return 512

    w = window.run_window(unit, seconds, sync=lambda: None, clock=clock)
    assert w["units"] == units
    assert w["frames"] == 512 * units
    assert w["seconds"] == pytest.approx(sum(durations[:units]))
    assert w["unit_seconds"] == pytest.approx(durations[:units])
    assert window.frames_per_s(w) == pytest.approx(
        512 * units / sum(durations[:units]))


def test_a_stall_counts_in_the_rate():
    """A slow chunk inside the window lowers the rate by its whole time,
    where a median of chunks would not move."""
    clock = Clock()
    it = iter([10.0, 30.0, 10.0, 10.0])

    def unit():
        clock.t += next(it)
        return 100

    w = window.run_window(unit, 40.0, sync=lambda: None, clock=clock)
    assert w["units"] == 2
    assert window.frames_per_s(w) == pytest.approx(200 / 40.0)


def test_sync_after_every_unit():
    calls = []
    clock = Clock()

    def unit():
        calls.append("unit")
        clock.t += 1.0
        return 1

    window.run_window(unit, 2.0, sync=lambda: calls.append("sync"),
                      clock=clock)
    assert calls == ["sync", "unit", "sync", "unit", "sync"]
