"""Device timing of the port's kernels and paths, with CUDA events."""

from __future__ import annotations

import torch

# Clock cycles of the spin kernel ``queued_ms`` queues its calls behind:
# about 10 ms at an H100's 1.98 GHz boost clock, far longer than the host
# takes to queue a few calls.
SPIN_CYCLES = 20_000_000


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, after one
    warm-up call, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls that
    the host queues behind a spin kernel (``torch.cuda._sleep``), so that
    the card runs them back to back: a call's device time with the gap
    between two launches on the card, without the host's cost of launching
    it (which paces ``cuda_ms`` for kernels of a few microseconds).  Raises
    if the spin ended before the host had queued the calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise RuntimeError("the spin ended before the calls were queued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
