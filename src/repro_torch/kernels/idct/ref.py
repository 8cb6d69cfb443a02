"""Plain PyTorch dequantize + IDCT: the CUDA kernel's reference and the CPU
path.

Same function as ``csrc/idct_dequant.cu``: ``D^T (q * M) D`` per block.
The products are the elementwise multiply-adds of
:func:`repro_torch.codec.transform.idct2_blocks` (the kernel's order, no
``matmul``), so a block's result never depends on its batch and the kernel
equals this version bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.codec.quant import dequantize
from repro_torch.codec.transform import idct2_blocks


def idct_dequant_ref(q: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """q: [N, 8, 8] int16 -> pixels/residual [N, 8, 8] f32."""
    return idct2_blocks(dequantize(q, qp, intra))
