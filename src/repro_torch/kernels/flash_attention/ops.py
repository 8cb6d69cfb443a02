"""Public entry of the attention kernels, differentiable.

``FlashAttentionFn`` is a ``torch.autograd.Function``: on CUDA tensors its
forward launches the forward kernel (``flash.py``), asking for the row
logsumexp only when a gradient will be taken, and its backward launches
the backward kernel (``flash_attention_bwd.py``); on CPU tensors both run
the plain PyTorch versions (``ref.py``).  Nothing falls back from one to
the other, and a ``DTensor`` raises ``TypeError``: a kernel takes a
rank's local tensors only.  On ``meta`` tensors both return empty outputs of the shapes
and dtypes the card returns, so a step can be walked without memory or
work (``repro_torch.launch.analytic_cost``).  Keys may be of another
length than the queries when not causal (cross-attention), and v may be
narrower than q and k (MLA): both kernels and both plain versions take
them.  ``flash_attention_op`` is the
call the models make.  The
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


def _no_dtensor(*xs: torch.Tensor) -> None:
    for x in xs:
        if type(x) is torch.Tensor:
            continue
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            raise TypeError(
                "flash_attention_op takes a rank's local tensors, not a "
                "DTensor: the kernels read raw pointers (run the model "
                "under distributed.parallel.local_params)")


def _device(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention_op runs on cuda, cpu or meta, "
                         f"got {q.device}")
    return q.device.type


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, save)``: q [B, H, S, Dqk], k [B, KV, Skv,
    Dqk] and v [B, KV, Skv, Dv] -> o [B, H, S, Dv] in q's dtype (Dv < Dqk
    is MLA's; Skv != S, not causal, cross-attention's).  ``save`` keeps
    what the backward needs (q, k, v, o and the f32 row logsumexp);
    without it the forward is the serving call and the backward raises.
    The backward runs the backward kernel on the card and the plain
    backward on the CPU, at every shape the forward takes; on ``meta``
    both return empty outputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, save: bool):
        _no_dtensor(q, k, v)
        dev = _device(q)
        if dev == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if save:
                o, lse = flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
            else:
                o, lse = flash_attention(q, k, v, causal=causal), None
        elif dev == "meta":
            o = q.new_empty(q.shape[:3] + v.shape[3:])
            lse = q.new_empty(q.shape[:3], dtype=torch.float32) if save \
                else None
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
        dev = _device(q)
        if dev == "cuda":
            dq, dk, dv = flash_attention_bwd(q, k, v, o, dout, lse,
                                             causal=ctx.causal)
        elif dev == "meta":
            dq, dk, dv = (x.new_empty(x.shape) for x in (q, k, v))
        else:
            dq, dk, dv = attention_bwd_ref(q, k, v, o, dout, lse,
                                           causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True) -> tuple:
    """``(o, lse)``: the forward with its f32 row logsumexp [B, H, S], for
    a caller that merges attention over blocks of keys (ring attention,
    ``distributed/ring_attention.py``): the kernel on CUDA tensors, the
    plain versions on the CPU; no gradient."""
    _no_dtensor(q, k, v)
    dev = _device(q)
    if dev == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, return_lse=True)
    return (attention_ref(q, k, v, causal=causal),
            attention_lse_ref(q, k, causal=causal))


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """q: [B, H, S, Dqk]; k: [B, KV, Skv, Dqk]; v: [B, KV, Skv, Dv] ->
    [B, H, S, Dv] in q's dtype, on the tensors' device, through
    :class:`FlashAttentionFn`; the row logsumexp is kept only where
    autograd records the call.  (A FLOP count,
    ``launch.analytic_cost.StepCount``, puts a charging subclass in
    ``FlashAttentionFn``'s place here while it is open.)"""
    _no_dtensor(q, k, v)
    save = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, save)
