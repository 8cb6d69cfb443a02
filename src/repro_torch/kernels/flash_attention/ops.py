"""Public entry of the attention kernels, differentiable.

``FlashAttentionFn`` is a ``torch.autograd.Function``: on CUDA tensors its
forward launches the forward kernel (``flash.py``), asking for the row
logsumexp only when a gradient will be taken, and its backward launches
the backward kernel (``flash_attention_bwd.py``); on CPU tensors both run
the plain PyTorch versions (``ref.py``).  Nothing falls back from one to
the other.  ``flash_attention_op`` is the call the models make.  The
reference halves its block sizes until they divide S; the kernels mask a
ragged last tile themselves, so any S is taken as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash import flash_attention
from repro_torch.kernels.flash_attention.flash_attention_bwd import \
    flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)


def _device(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention_op runs on cuda or cpu, got "
                         f"{q.device}")
    return q.device.type


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, save)``: q [B, H, S, D], k and v
    [B, KV, S, D] -> o [B, H, S, D] in q's dtype.  ``save`` keeps what the
    backward needs (q, k, v, o and the f32 row logsumexp); without it the
    forward is the serving call and the backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, save: bool):
        if _device(q) == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if save:
                o, lse = flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
            else:
                o, lse = flash_attention(q, k, v, causal=causal), None
        else:
            o = attention_ref(q, k, v, causal=causal)
            lse = attention_lse_ref(q, k, causal=causal) if save else None
        ctx.causal, ctx.saved = causal, save
        if save:
            ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        if not ctx.saved:
            raise RuntimeError("FlashAttentionFn was applied with save=False;"
                               " call flash_attention_op with grad enabled")
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if _device(q) == "cuda":
            dq, dk, dv = flash_attention_bwd(q, k, v, o, dout, lse,
                                             causal=ctx.causal)
        else:
            dq, dk, dv = attention_bwd_ref(q, k, v, o, dout, lse,
                                           causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """q: [B, H, S, D]; k, v: [B, KV, S, D] -> [B, H, S, D] in q's dtype,
    on the tensors' device, through :class:`FlashAttentionFn`; the row
    logsumexp is kept only where autograd records the call."""
    save = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, save)
