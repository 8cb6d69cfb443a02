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


def stream_bytes_np(q: np.ndarray) -> float:
    """Total estimated bytes for a tensor of quantized blocks."""
    flat = q.reshape(-1, 64).astype(np.float32)
    zz = flat[:, _zigzag_order()]
    mag = np.abs(zz)
    coef_bits = np.where(mag > 0, 2.0 * np.log2(mag + 1.0) + 1.0, 0.0)
    nz = (mag > 0).sum(axis=-1).astype(np.float32)
    run_bits = 4.0 + 2.0 * nz
    return float(coef_bits.sum() + run_bits.sum()) / 8.0 + 64.0
