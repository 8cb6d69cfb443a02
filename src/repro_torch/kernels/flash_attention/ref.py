"""Plain PyTorch attention: the CUDA kernel's reference and the CPU path.

Same function as ``csrc/flash_attention.cu`` and as the reference's
``attention_ref``: GQA attention in f32, masked scores ``-1e30``, cast
back to q's dtype.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: [B, H, S, D]; k, v: [B, KV, S, D] with H % KV == 0."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    g = h // kv
    qg = q.reshape(b, kv, g, s, d).float()
    scores = torch.einsum("bkgqd,bkpd->bkgqp", qg, k.float())
    scores = scores / math.sqrt(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqp,bkpd->bkgqd", w, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)
