"""Per-layer blocks (``init_block`` / ``block_apply``).

Counterpart of the reference's ``models/blocks.py``.  A dense or moe
block is pre-norm attention (MLA when the config has ``mla``, as
DeepSeek's dense and MoE layers do), then the pre-norm SwiGLU MLP (dense)
or the routed-expert FFN (moe, ``models/moe.py``); an SSM block (ssm1,
ssm2) is the pre-norm Mamba-1 or Mamba-2 mixer of ``models/ssm.py``.  An
encoder block (enc) is a dense block whose attention the caller runs
unmasked; a decoder block (dec) puts pre-norm cross-attention (``ln_x``,
``cross``) between its causal self-attention and its MLP: queries from
the decoder, keys and values projected from the encoder's output
``enc_out`` at every call (no RoPE, and no cache: the reference
recomputes them at every decode step, and so does the port).  Each adds
to the residual stream in the compute dtype.  The reference's sharding
constraints are no-ops on one device and are dropped; on a mesh each
sublayer runs its tensor-parallel schedule (``distributed/parallel.py``),
cross-attention over this rank's heads (``parallel.cross_group``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import parallel
from repro_torch.models.attention import (Attention, MLAAttention,
                                          attention_apply, grouped_attention,
                                          mla_apply)
from repro_torch.models.layers import (MLP, Norm, dense_cols, dense_rows,
                                       mlp_apply, norm_apply)
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.ssm import Mamba1, Mamba2, mamba1_apply, mamba2_apply

SSM_KINDS = ("ssm1", "ssm2")
KINDS = ("dense", "moe", "enc", "dec") + SSM_KINDS


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the kinds are "
                         f"{KINDS}")


class Block(nn.Module):
    """``ln1`` and ``mamba`` (ssm1, ssm2), or ``ln1``, ``attn`` (GQA or
    MLA), ``ln2`` and ``mlp`` (dense, enc) or ``moe`` (moe), and in a dec
    block ``ln_x`` and ``cross`` between them."""

    def __init__(self, cfg: ArchConfig, kind: str = "dense", *,
                 device="cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_kind(kind)
        dt = cfg.param_dtype
        kw = dict(device=device, generator=generator)
        self.ln1 = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
        if kind in SSM_KINDS:
            self.mamba = (Mamba1 if kind == "ssm1" else Mamba2)(cfg, **kw)
            return
        self.attn = (MLAAttention if cfg.mla is not None
                     else Attention)(cfg, **kw)
        if kind == "dec":
            self.ln_x = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
            self.cross = Attention(cfg, **kw)
        self.ln2 = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
        if kind == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype=dt, **kw)


def init_block(cfg: ArchConfig, kind: str = "dense", *, device="cpu",
               generator: Optional[torch.Generator] = None) -> Block:
    """One layer's parameters (``kind`` is one of :data:`KINDS`)."""
    return Block(cfg, kind, device=device, generator=generator)


def block_apply(p: Block, h: torch.Tensor, cfg: ArchConfig, kind: str, *,
                positions=None, cache: Optional[dict] = None,
                cache_index=None, cache_len=None, enc_out=None,
                causal: bool = True):
    """Returns (h, cache_or_None).  An attention block updates its KV
    cache in place and returns it; an SSM block reads its state from
    ``cache`` and returns the new state, which the caller writes back.  A
    dec block attends over ``enc_out`` [B, Se, d] after its
    self-attention."""
    _check_kind(kind)
    hn = norm_apply(cfg.norm, p.ln1, h)
    if kind in SSM_KINDS:
        fn = mamba1_apply if kind == "ssm1" else mamba2_apply
        y, state = fn(p.mamba, hn, cfg, state=cache)
        return h + y, state
    attn_fn = mla_apply if cfg.mla is not None else attention_apply
    a, cache = attn_fn(p.attn, hn, cfg, causal=causal, positions=positions,
                       kv_cache=cache, cache_index=cache_index,
                       cache_len=cache_len)
    h = h + a
    if kind == "dec":
        hn = norm_apply(cfg.norm, p.ln_x, h)
        h = h + _cross_attention(p.cross, hn, enc_out, cfg)
    hn = norm_apply(cfg.norm, p.ln2, h)
    if kind == "moe":
        f = moe_apply(p.moe, hn, cfg)
    else:
        f = mlp_apply(p.mlp, hn, cfg.compute_dtype,
                      tp=parallel.mlp_group(cfg.d_ff))
    return h + f, cache


def _cross_attention(p: Attention, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """Decoder cross-attention: queries from x [B, S, d], keys and values
    from enc_out [B, Se, d], no RoPE and no mask.  With S > 1 (a prefill,
    or a training forward) it runs the ``chunked`` path, the flash kernel
    over Se keys; a decode step's one query runs the naive path, as in
    the reference.  On a mesh that splits its heads (``p`` then holds
    this rank's q/k/v columns and ``wo`` rows) ``x`` and ``enc_out``
    enter through ``dense_cols`` and the partial output leaves through
    ``dense_rows``."""
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    hd = cfg.head_dim
    cd = cfg.compute_dtype
    g = parallel.cross_group(cfg)  # this rank's heads only
    q, = dense_cols((p.wq,), x, cd, g)
    k, v = dense_cols((p.wk, p.wv), enc_out, cd, g)
    kvh = k.shape[-1] // hd
    q = q.reshape(B, S, kvh, q.shape[-1] // (kvh * hd), hd)
    k = k.reshape(B, Se, kvh, hd)
    v = v.reshape(B, Se, kvh, hd)
    out = grouped_attention(
        q, k, v, causal=False, q_pos=torch.arange(S, device=x.device),
        kv_pos=torch.arange(Se, device=x.device),
        impl="chunked" if S > 1 else "naive", q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk)
    return dense_rows(p.wo, out.reshape(B, S, -1), cd, g)
