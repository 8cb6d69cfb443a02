"""Wall-clock timing helpers for benchmarks (host measurements).

Counterpart of the reference's ``utils/timing.py``: where the reference
blocks on JAX outputs, ``time_call`` synchronises the CUDA device of every
tensor the call returns.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.utils.tree import flatten_names


class Timer:
    """Context-manager timer: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        self.us = self.seconds * 1e6


def block_until_ready(out: Any) -> Any:
    """Wait for the CUDA work behind every tensor of ``out``."""
    devices = {leaf.device for _, leaf in flatten_names(out)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def time_call(fn: Callable[[], Any], warmup: int = 1, iters: int = 3) -> float:
    """Median wall-clock microseconds per call; waits for the outputs'
    CUDA work."""

    def run() -> float:
        t0 = time.perf_counter()
        out = fn()
        block_until_ready(out)
        return (time.perf_counter() - t0) * 1e6

    for _ in range(warmup):
        run()
    times = sorted(run() for _ in range(iters))
    return times[len(times) // 2]
