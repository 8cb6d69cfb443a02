"""Per-layer blocks (``init_block`` / ``block_apply``).

Counterpart of the reference's ``models/blocks.py`` for kinds ``"dense"``,
``"moe"``, ``"ssm1"`` and ``"ssm2"``.  A dense or moe block is pre-norm
attention (MLA when the config has ``mla``, as DeepSeek's dense and MoE
layers do), then the pre-norm SwiGLU MLP (dense) or the routed-expert FFN
(moe, ``models/moe.py``); an SSM block is the pre-norm Mamba-1 (ssm1) or
Mamba-2 (ssm2) mixer of ``models/ssm.py``.  Each adds to the residual
stream in the compute dtype.  The reference's sharding constraints are
no-ops on one device and are dropped.  The encoder-decoder kinds (enc,
dec) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (Attention, MLAAttention,
                                          attention_apply, mla_apply)
from repro_torch.models.layers import MLP, Norm, mlp_apply, norm_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.ssm import Mamba1, Mamba2, mamba1_apply, mamba2_apply

SSM_KINDS = ("ssm1", "ssm2")
KINDS = ("dense", "moe") + SSM_KINDS


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP, queue 1 item "
            f"7); the port has {KINDS}")


class Block(nn.Module):
    """``ln1`` and ``mamba`` (ssm1, ssm2), or ``ln1``, ``attn`` (GQA or
    MLA), ``ln2`` and ``mlp`` (dense) or ``moe`` (moe)."""

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
                cache_index=None, cache_len=None, causal: bool = True):
    """Returns (h, cache_or_None).  An attention block updates its KV
    cache in place and returns it; an SSM block reads its state from
    ``cache`` and returns the new state, which the caller writes back."""
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
    hn = norm_apply(cfg.norm, p.ln2, h)
    if kind == "moe":
        f = moe_apply(p.moe, hn, cfg)
    else:
        f = mlp_apply(p.mlp, hn, cfg.compute_dtype)
    return h + f, cache
