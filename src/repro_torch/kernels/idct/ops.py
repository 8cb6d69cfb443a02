"""Public entry of the dequantize + IDCT kernel.

A tensor on a CUDA device goes to the CUDA kernel (``idct.py``); a tensor
on the CPU goes to the plain PyTorch version (``ref.py``).  Nothing falls
back from one to the other.  N is used as it is (no padding: a CUDA launch
has no per-shape compile).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.idct.idct import idct_dequant
from repro_torch.kernels.idct.ref import idct_dequant_ref


def idct_dequant_op(q: torch.Tensor, *, qp: int,
                    intra: bool) -> torch.Tensor:
    """[N, 8, 8] int16 -> [N, 8, 8] f32 ``D^T (q * M) D``, on ``q``'s
    device."""
    if q.device.type == "cuda":
        return idct_dequant(q.contiguous(), qp, intra)
    if q.device.type != "cpu":
        raise ValueError(f"idct_dequant_op runs on cuda or cpu, got "
                         f"{q.device}")
    return idct_dequant_ref(q, qp, intra)
