"""Blockwise 8x8 DCT-II basis.

The 8x8 DCT is two small constant matmuls per block (``D @ X @ D.T``); the
numpy codec (``codec/encode.py``) and the CUDA decode kernel
(``kernels/decode``) both take ``D`` from here.
"""
from __future__ import annotations

import functools

import numpy as np

BLOCK = 8


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II basis matrix [n, n] (float32)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    m[0] = np.sqrt(1.0 / n)
    return m.astype(np.float32)

