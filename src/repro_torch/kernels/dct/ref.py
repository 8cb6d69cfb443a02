"""Plain PyTorch DCT + quantize: the CUDA kernel's reference and the CPU
path.

Same function as ``csrc/dct_quant.cu``: ``round(D X D^T / M)`` per block,
round half to even.  The products are the elementwise multiply-adds of
:func:`repro_torch.codec.transform.dct2_blocks` (the kernel's order, no
``matmul``), so a block's result never depends on its batch and the kernel
equals this version bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.codec.quant import quantize
from repro_torch.codec.transform import dct2_blocks


def dct_quant_ref(blocks: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """blocks: [N, 8, 8] f32 -> quantized coeffs [N, 8, 8] int16."""
    return quantize(dct2_blocks(blocks), qp, intra)
