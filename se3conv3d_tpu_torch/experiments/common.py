"""What the probe entry points share: the card check and CUDA-event timing."""
from __future__ import annotations

import statistics
from typing import Callable

import torch

__all__ = ["require_cuda", "cuda_median_ms"]


def require_cuda(prog: str) -> torch.device:
    """The card the probe runs on; raises without one (a probe measures
    the card and never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{prog} measures an NVIDIA GPU and found no CUDA device")
    return torch.device("cuda")


def cuda_median_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2, calls: int = 10) -> float:
    """Median milliseconds per call of ``fn()``: ``reps`` samples, each
    ``calls`` calls between two CUDA events, after ``warmup`` calls.  The
    calls queue back to back, so a kernel that runs longer than the host's
    work per call is timed without that work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
