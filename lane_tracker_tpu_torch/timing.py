"""Device timing of the port's kernels and paths, with CUDA events."""

from __future__ import annotations

import torch


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
