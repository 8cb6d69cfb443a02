"""Attention: GQA/MHA, full-sequence and decode-with-cache.

Counterpart of the GQA part of the reference's ``models/attention.py``.
The reference computes every full-sequence attention with its chunked
online-softmax jnp path, validated against the same oracle as its Pallas
``flash_attention`` kernel.  The port sends that case through the kernel's
counterpart, ``repro_torch.kernels.flash_attention`` (the CUDA kernel on a
CUDA tensor, its plain version on the CPU); decode (one query against the
cache) stays plain torch, as the reference's naive path.

MLA, the int8 KV cache, the sequence-sharded cache and cross-attention are
not ported yet (ROADMAP, queue 1 item 10) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import (Dense, Norm, apply_rope, dense_apply,
                                       norm_apply)

NEG_INF = -1e30
_TODO = "not ported yet (ROADMAP, queue 1 item 10)"


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the attention variants the port does not have yet."""
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA attention is {_TODO}")
    if cfg.kv_cache_quant:
        raise NotImplementedError(f"the int8 KV cache is {_TODO}")
    if cfg.kv_cache_shard != "heads":
        raise NotImplementedError(
            f"kv_cache_shard={cfg.kv_cache_shard!r} is {_TODO}")


# ==========================================================================
# Parameters
# ==========================================================================
class Attention(nn.Module):
    """Standard q/k/v/o projections for MHA/GQA (``init_attention``)."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=cfg.param_dtype, device=device, generator=generator)
        self.wq = Dense(d, h * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Dense(d, kvh * hd, bias=cfg.qkv_bias, **kw)
        self.wv = Dense(d, kvh * hd, bias=cfg.qkv_bias, **kw)
        self.wo = Dense(h * hd, d, **kw)
        norm = dict(dtype=cfg.param_dtype, device=device)
        self.q_norm = Norm("rmsnorm", hd, **norm) if cfg.qk_norm else None
        self.k_norm = Norm("rmsnorm", hd, **norm) if cfg.qk_norm else None


# ==========================================================================
# Core softmax-attention over explicit q/k/v (heads grouped for GQA)
# ==========================================================================
def _naive_attention(q, k, v, *, causal: bool, q_pos, kv_pos, kv_len=None):
    """q: [B,Sq,KV,G,D]; k,v: [B,Skv,KV,D]. Returns [B,Sq,KV,G,D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgd,bpkd->bkgqp", q.float(), k.float())
    s = s * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    if kv_len is not None:
        mask = mask & (kv_pos[None, :] < kv_len)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bqkgd", w, v.float())
    return out.to(q.dtype)


def _flash_attention(q, k, v, *, causal: bool):
    """The kernel over q [B,S,KV,G,D] and k, v [B,S,KV,D]: query head
    ``kv*G + g`` reads KV head ``kv``, as the kernel's ``bh // G`` does."""
    B, S, KV, G, D = q.shape
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, S, D)
    out = flash_attention_op(qh, k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal)
    return out.reshape(B, KV, G, S, D).permute(0, 3, 1, 2, 4)


def grouped_attention(q, k, v, *, causal, q_pos, kv_pos, impl="chunked",
                      q_chunk=512, kv_chunk=512, kv_len=None):
    """Dispatch over attention implementations. Shapes as in
    ``_naive_attention``.

    ``chunked`` and ``chunked_noskip`` (the reference's online-softmax
    paths, with and without the causal block skip: one function) run the
    flash kernel when queries and keys are the same sequence.  The kernel
    masks by index, which is the positional mask when ``q_pos`` is
    ``kv_pos``, as every caller passes them.  ``q_chunk`` and ``kv_chunk``
    are the reference's tiling and do not change the function."""
    Sq, Skv = q.shape[1], k.shape[1]
    if impl == "naive" or Sq == 1:
        return _naive_attention(q, k, v, causal=causal, q_pos=q_pos,
                                kv_pos=kv_pos, kv_len=kv_len)
    if impl in ("chunked", "chunked_noskip"):
        if Sq != Skv or kv_len is not None or q_pos is not kv_pos:
            raise NotImplementedError(
                "the port's full-sequence attention takes queries and keys "
                "of one sequence (no caller of the reference passes others)")
        return _flash_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")


# ==========================================================================
# GQA block (full-sequence, prefill into a cache, single-token decode)
# ==========================================================================
def attention_apply(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                    causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    kv_cache: Optional[dict] = None,
                    cache_index: Optional[int] = None,
                    cache_len: Optional[int] = None):
    """x: [B, S, d].  Returns (out [B,S,d], cache|None).

    With ``kv_cache`` ({"k", "v"}: [B, max_len, KV, D]) the new k and v are
    written at ``cache_index`` IN PLACE (the reference returns an updated
    copy; the port returns the same, updated dict).  S == 1 is a decode
    step over ``cache[:cache_len]``; S > 1 is a prefill and needs
    ``cache_index == 0``."""
    check_supported(cfg)
    B, S, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = h // kvh
    cd = cfg.compute_dtype

    q = dense_apply(p.wq, x, cd).reshape(B, S, kvh, G, hd)
    k = dense_apply(p.wk, x, cd).reshape(B, S, kvh, hd)
    v = dense_apply(p.wv, x, cd).reshape(B, S, kvh, hd)
    if cfg.qk_norm:
        q = norm_apply("rmsnorm", p.q_norm, q)
        k = norm_apply("rmsnorm", p.k_norm, k)

    if positions is None:
        positions = torch.arange(S, device=x.device)
        if cache_index is not None:
            positions = positions + int(cache_index)
    q = apply_rope(q.reshape(B, S, kvh * G, hd), positions, cfg.rope_theta)
    q = q.reshape(B, S, kvh, G, hd)
    k = apply_rope(k, positions, cfg.rope_theta)

    rep = cfg.kv_repeat
    if rep > 1:  # vLLM-style KV-head replication so TP divides the KV axis
        assert G % rep == 0, (G, rep)
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        q = q.reshape(B, S, kvh, rep, G // rep, hd).reshape(
            B, S, kvh * rep, G // rep, hd)
        kvh, G = kvh * rep, G // rep

    if kv_cache is None:
        out = grouped_attention(q, k, v, causal=causal, q_pos=positions,
                                kv_pos=positions, impl=cfg.attention_impl,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        idx = int(cache_index)
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, idx:idx + S] = k.to(ck.dtype)
        cv[:, idx:idx + S] = v.to(cv.dtype)
        if S == 1:  # decode: the naive path over the cache, as the reference
            kv_pos = torch.arange(ck.shape[1], device=x.device)
            out = grouped_attention(q, ck, cv, causal=False, q_pos=positions,
                                    kv_pos=kv_pos, impl=cfg.attention_impl,
                                    kv_len=cache_len)
        elif idx == 0:
            # Prefill from an empty cache.  The reference attends over the
            # whole max_len cache with a causal mask and kv_len = S; every
            # key at a position >= S is masked there by both, so that is
            # causal attention over the prompt's own k and v (the values
            # just written to cache[:, :S]), which is what the kernel takes.
            out = grouped_attention(q, k.to(ck.dtype), v.to(cv.dtype),
                                    causal=True, q_pos=positions,
                                    kv_pos=positions, impl=cfg.attention_impl,
                                    q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk)
        else:
            raise NotImplementedError(
                "prefill at cache_index > 0 (a chunked prefill) has no "
                "caller in the reference and is not ported")

    out = out.reshape(B, S, h * hd)
    return dense_apply(p.wo, out, cd), kv_cache
