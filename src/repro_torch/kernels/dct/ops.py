"""Public entry of the DCT + quantize kernel.

A tensor on a CUDA device goes to the CUDA kernel (``dct.py``); a tensor on
the CPU goes to the plain PyTorch version (``ref.py``).  Nothing falls back
from one to the other.  The reference pads N to a power-of-two bucket only
to bound jit retraces; a CUDA launch has no per-shape compile, so N is used
as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dct.dct import dct_quant
from repro_torch.kernels.dct.ref import dct_quant_ref


def dct_quant_op(blocks: torch.Tensor, *, qp: int,
                 intra: bool) -> torch.Tensor:
    """[N, 8, 8] f32 -> [N, 8, 8] int16 ``round(D X D^T / M)``, on
    ``blocks``' device."""
    if blocks.device.type == "cuda":
        return dct_quant(blocks.contiguous(), qp, intra)
    if blocks.device.type != "cpu":
        raise ValueError(f"dct_quant_op runs on cuda or cpu, got "
                         f"{blocks.device}")
    return dct_quant_ref(blocks, qp, intra)
