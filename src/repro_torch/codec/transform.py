"""Blockwise 8x8 DCT-II transform: the basis and its torch helpers.

The 8x8 DCT is two small constant products per block (``D @ X @ D.T``);
the numpy codec (``codec/encode.py``) and the CUDA kernels
(``kernels/{decode,dct,idct}``) all take ``D`` from here.

The torch helpers are the plain versions of the kernels' products: each
8-point sum is written as elementwise multiply-adds in the kernels' order
(j, then k, ascending, starting from the first product), never as a
``matmul``, whose CPU rounding may depend on how many blocks it is given.
So a block's result depends only on that block, and the CUDA kernels,
which round every product and sum separately in the same order, equal
these helpers bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK = 8


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II basis matrix [n, n] (float32)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    m[0] = np.sqrt(1.0 / n)
    return m.astype(np.float32)



def _basis(device) -> torch.Tensor:
    return torch.from_numpy(dct_matrix()).to(device)


def to_blocks(frame: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """[..., H, W] -> [..., H/b * W/b, b, b] row-major blocks (a view where
    the layout allows).  H, W must divide b."""
    h, w = frame.shape[-2:]
    lead = tuple(frame.shape[:-2])
    nb_h, nb_w = h // block, w // block
    x = frame.reshape(lead + (nb_h, block, nb_w, block))
    x = x.transpose(-3, -2)
    return x.reshape(lead + (nb_h * nb_w, block, block))


def from_blocks(blocks: torch.Tensor, h: int, w: int,
                block: int = BLOCK) -> torch.Tensor:
    """[..., H/b * W/b, b, b] row-major blocks -> [..., H, W]."""
    nb_h, nb_w = h // block, w // block
    lead = tuple(blocks.shape[:-3])
    x = blocks.reshape(lead + (nb_h, nb_w, block, block))
    x = x.transpose(-3, -2)
    return x.reshape(lead + (h, w))


def dct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """2D DCT per block, ``D X D^T``: [..., 8, 8] -> [..., 8, 8] f32."""
    x = blocks.to(torch.float32)
    d = _basis(x.device)
    # t[..., i, l] = sum_j D[i, j] * x[..., j, l]
    t = d[:, 0:1] * x[..., 0:1, :]
    for j in range(1, 8):
        t = t + d[:, j:j + 1] * x[..., j:j + 1, :]
    # c[..., i, l] = sum_k t[..., i, k] * D[l, k]
    c = t[..., :, 0:1] * d[:, 0]
    for k in range(1, 8):
        c = c + t[..., :, k:k + 1] * d[:, k]
    return c


def idct2_blocks(coeffs: torch.Tensor) -> torch.Tensor:
    """2D inverse DCT per block, ``D^T C D``: [..., 8, 8] -> [..., 8, 8]
    f32."""
    c = coeffs.to(torch.float32)
    d = _basis(c.device)
    # t[..., i, l] = sum_j D[j, i] * c[..., j, l]
    t = d[0, :, None] * c[..., 0:1, :]
    for j in range(1, 8):
        t = t + d[j, :, None] * c[..., j:j + 1, :]
    # x[..., i, l] = sum_k t[..., i, k] * D[k, l]
    x = t[..., :, 0:1] * d[0]
    for k in range(1, 8):
        x = x + t[..., :, k:k + 1] * d[k]
    return x
