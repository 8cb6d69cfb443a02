"""Pieces the cell loops share: the device's clock and memory, and the
switch to the reference's arithmetic."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def memory_peak(device: str) -> int:
    """Peak bytes allocated on the card since the last reset (0 on the
    CPU, where there is no card to read)."""
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free(device: str) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def plain_f32() -> None:
    """Float32 products in float32: no TF32 (the reference's arithmetic)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rng(seed: int, stream: int) -> np.random.Generator:
    """The run's generator for one stream of draws (video, traffic,
    sampling): independent streams from one ``--seed``."""
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def now() -> float:
    return time.perf_counter()


def log(line: str) -> None:
    """A line of the run's own account on standard error (before the
    compared numbers, which come last there)."""
    print(line, file=sys.stderr, flush=True)
