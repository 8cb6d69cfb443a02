"""Quantization for the transform codec.

A JPEG-style base matrix scaled by QP; intra (keyframe) blocks use the full
matrix, inter (residual) blocks a flatter one — mirroring how real codecs
spend more bits on keyframes (this is what makes short GOPs storage-heavy,
the effect behind the paper's Fig. 9 tradeoff).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# JPEG luminance base quantization matrix
_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def quant_matrix(qp: int, intra: bool) -> np.ndarray:
    scale = max(qp, 1) / 16.0
    m = _BASE * scale
    if not intra:
        m = np.maximum(m * 0.75, 1.0)  # flatter for residuals
    return np.maximum(m, 1.0).astype(np.float32)



def _matrix(qp: int, intra: bool, device) -> torch.Tensor:
    return torch.from_numpy(quant_matrix(qp, intra)).to(device)


def quantize(coeffs: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """``round(coeffs / M)`` to int16: IEEE division, round half to even
    (as ``np.round``), clamped to the int16 range."""
    m = _matrix(qp, intra, coeffs.device)
    q = torch.round(coeffs.to(torch.float32) / m)
    return q.clamp_(-32768, 32767).to(torch.int16)


def dequantize(q: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """``q * M`` in f32."""
    return q.to(torch.float32) * _matrix(qp, intra, q.device)
