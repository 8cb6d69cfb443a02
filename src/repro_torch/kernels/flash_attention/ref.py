"""Plain PyTorch attention: the CUDA kernel's reference and the CPU path.

Same function as ``csrc/flash_attention.cu`` and as the reference's
``attention_ref``: GQA attention in f32, masked scores ``-1e30``, cast
back to q's dtype.  v may be narrower than q and k (MLA), as in the
reference's chunked attention: the output takes v's width and the scale
stays ``1/sqrt(Dqk)``.  k and v may be of another length Skv than q's S
when not causal (cross-attention); causal attention with two lengths
raises ``ValueError`` rather than guess how they align (the reference
never asks for it).  ``attention_lse_ref`` is the row logsumexp the forward
kernel writes for the backward, and ``attention_bwd_ref`` the gradient
that ``csrc/flash_attention_bwd.cu`` computes from it.
``attention_bf16_mma_ref`` and ``attention_bwd_bf16_mma_ref`` emulate the
rounding of the two kernels' bf16 (tensor-core) paths, so the CPU can
hold their designs to the tolerance; they are on no serving or training
path.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: [B, H, S, Dqk]; k: [B, KV, Skv, Dqk]; v: [B, KV, Skv, Dv] with
    H % KV == 0 (Skv == S when ``causal``).  Returns [B, H, S, Dv]."""
    b, h, s, _ = q.shape
    w = torch.softmax(_scores(q, k, causal), dim=-1)
    out = torch.einsum("bkgqp,bkpd->bkgqd", w, v.float())
    return out.reshape(b, h, s, v.shape[3]).to(q.dtype)


def _check_lengths(q: torch.Tensor, k: torch.Tensor, causal: bool) -> None:
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(f"causal attention needs keys of the queries' "
                         f"length, got S={q.shape[2]} and Skv={k.shape[2]}")


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled, masked f32 scores [B, KV, G, S, Skv] (masked to -1e30)."""
    _check_lengths(q, k, causal)
    b, h, s, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, s, d).float()
    scores = torch.einsum("bkgqd,bkpd->bkgqp", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    return scores


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """Each query row's logsumexp of its scaled, masked scores, f32
    [B, H, S], in the natural log domain (what the forward kernel writes
    with ``return_lse``)."""
    b, h, s, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(b, h, s)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True) -> tuple:
    """The gradient of ``attention_ref`` from its output ``o`` and row
    logsumexp ``lse``, in f32, as the backward kernel computes it:
    P = exp(scores - lse), dv = P^T dO and dk = dS^T q / sqrt(D) summed over
    the G query heads of each KV head, dq = dS k / sqrt(D), with
    dS = P (dO v^T - rowsum(dO o)).  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    return _attention_bwd(q, k, v, o, dout, lse, causal, lambda x: x)


def _attention_bwd(q, k, v, o, dout, lse, causal: bool,
                   operand) -> tuple:
    """``attention_bwd_ref`` with P and dS passed through ``operand``
    before the products that take them (dv, dk, dq)."""
    b, h, s, d = q.shape
    kv, d_v = k.shape[1], v.shape[3]
    shape = (b, kv, h // kv, s)
    lse = lse.float().reshape(shape)[..., None]
    p = torch.exp(_scores(q, k, causal) - lse)
    do = dout.float().reshape(*shape, d_v)
    qf, kf, vf = q.float().reshape(*shape, d), k.float(), v.float()
    dv = torch.einsum("bkgqp,bkgqd->bkpd", operand(p), do)
    dp = torch.einsum("bkgqd,bkpd->bkgqp", do, vf)
    delta = (do * o.float().reshape(*shape, d_v)).sum(dim=-1)
    ds = operand(p * (dp - delta[..., None]))
    dq = torch.einsum("bkgqp,bkpd->bkgqd", ds, kf) / math.sqrt(d)
    dk = torch.einsum("bkgqp,bkgqd->bkpd", ds, qf) / math.sqrt(d)
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


#: keys per tile of the CUDA kernel's bf16 path
KERNEL_BKV = 64


def attention_bf16_mma_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           split_p: bool = True) -> torch.Tensor:
    """The numerics of the CUDA kernel's bf16 path, in plain PyTorch:
    scores in f32 from the bf16 inputs, scaled into the log2 domain, an
    online softmax over 64-key tiles with ``exp2``, P split into ``P_hi``
    (P rounded to bf16) and ``P_lo`` (the remainder rounded to bf16) with
    one PV product each, accumulated in f32, the row sum taken over the f32
    P and clamped to 1e-30, the output cast to q's dtype.  ``split_p=False``
    keeps ``P_hi`` alone: the rounding the kernel's design rejected.
    Keys may be of another length than the queries when not causal."""
    _check_lengths(q, k, causal)
    b, h, s, d = q.shape
    kv, d_v = k.shape[1], v.shape[3]
    shape = (b, kv, h // kv, s)
    qf = q.float().reshape(*shape, d)
    kf, vf = k.float(), v.float()
    scale_log2 = torch.tensor(math.log2(math.e) / math.sqrt(d),
                              dtype=torch.float32)
    m = torch.full(shape, -1e30, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros((*shape, d_v), device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    for j0 in range(0, k.shape[2], KERNEL_BKV):
        kt, vt = kf[:, :, j0:j0 + KERNEL_BKV], vf[:, :, j0:j0 + KERNEL_BKV]
        sc = torch.einsum("bkgqd,bkpd->bkgqp", qf, kt) * scale_log2
        if causal:
            kpos = torch.arange(j0, j0 + kt.shape[2], device=q.device)[None]
            sc = sc.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        p_hi = p.bfloat16().float()
        pv = torch.einsum("bkgqp,bkpd->bkgqd", p_hi, vt)
        if split_p:
            p_lo = (p - p_hi).bfloat16().float()
            pv = pv + torch.einsum("bkgqp,bkpd->bkgqd", p_lo, vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, s, d_v).to(q.dtype)


def _bf16_parts(x: torch.Tensor, split: bool) -> torch.Tensor:
    """``x`` as the tensor cores take it: rounded to bf16 (``hi``), plus
    the remainder rounded to bf16 (``lo``) when ``split``; in f32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def attention_bwd_bf16_mma_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               dout: torch.Tensor, lse: torch.Tensor, *,
                               causal: bool = True,
                               split: bool = True) -> tuple:
    """The numerics of the backward kernel's bf16 path, in plain PyTorch:
    S, dP and delta in f32 from the inputs, P = exp(scores - lse) and
    dS = P (dP - delta) in f32, then P and dS rounded to bf16 parts
    (``hi + lo`` with ``split``, ``hi`` alone without) before the f32
    products dv = P^T dO, dk = dS^T q / sqrt(D) (summed over the G query
    heads) and dq = dS k / sqrt(D), each gradient rounded once to the
    inputs' dtypes.  Given f32 copies of bf16 inputs, it returns the f32
    gradients before that last rounding."""
    return _attention_bwd(q, k, v, o, dout, lse, causal,
                          lambda x: _bf16_parts(x, split))
