"""Public entry of the attention kernel.

A tensor on a CUDA device goes to the CUDA kernel (``flash.py``); a tensor
on the CPU goes to the plain PyTorch version (``ref.py``).  Nothing falls
back from one to the other.  The reference halves its block sizes until
they divide S; the kernel masks a ragged last tile itself, so any S is
taken as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """q: [B, H, S, D]; k, v: [B, KV, S, D] -> [B, H, S, D] in q's dtype,
    on the tensors' device."""
    if q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_op runs on cuda or cpu, got "
                         f"{q.device}")
    return attention_ref(q, k, v, causal=causal)
