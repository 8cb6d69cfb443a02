"""Entropy-coded size model.

We do not implement a binary arithmetic coder; storage size is estimated from
the quantized coefficients with a zig-zag run-length + exp-Golomb bit model,
which tracks real codec size behaviour (keyframes cost more, busy tiles cost
more, empty residual blocks cost ~nothing).  The estimate is deterministic
and is what the paper's storage-size experiments (Fig. 9) measure against.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _zigzag_order(n: int = 8) -> np.ndarray:
    idx = np.arange(n * n).reshape(n, n)
    order = []
    for s in range(2 * n - 1):
        diag = [(i, s - i) for i in range(n) if 0 <= s - i < n]
        if s % 2 == 0:
            diag = diag[::-1]
        order.extend(idx[i, j] for i, j in diag)
    return np.asarray(order, dtype=np.int32)


def block_bits(q: torch.Tensor) -> torch.Tensor:
    """Estimated bits per 8x8 quantized block.  q: [..., 8, 8] int."""
    flat = q.reshape(tuple(q.shape[:-2]) + (64,)).to(torch.float32)
    order = torch.from_numpy(_zigzag_order()).to(q.device, torch.long)
    mag = flat[..., order].abs()
    # exp-Golomb-ish: ~ 2*log2(|c|+1)+1 bits per nonzero coefficient
    coef_bits = torch.where(mag > 0, 2.0 * torch.log2(mag + 1.0) + 1.0,
                            torch.zeros_like(mag))
    nz = (mag > 0).to(torch.float32)
    # run-length overhead: ~ one terminator + per-nonzero position cost
    run_bits = 4.0 + 2.0 * nz.sum(-1)
    return coef_bits.sum(-1) + run_bits


def stream_bytes(q: torch.Tensor) -> float:
    """Total estimated bytes for a tensor of quantized blocks."""
    return float(block_bits(q).sum()) / 8.0 + 64.0  # + tiny header


def stream_bytes_np(q: np.ndarray) -> float:
    """Numpy fast path of ``stream_bytes`` (same model): the size of
    record, which the store keeps."""
    flat = q.reshape(-1, 64).astype(np.float32)
    zz = flat[:, _zigzag_order()]
    mag = np.abs(zz)
    coef_bits = np.where(mag > 0, 2.0 * np.log2(mag + 1.0) + 1.0, 0.0)
    nz = (mag > 0).sum(axis=-1).astype(np.float32)
    run_bits = 4.0 + 2.0 * nz
    return float(coef_bits.sum() + run_bits.sum()) / 8.0 + 64.0
