"""Per-layer transformer blocks (``init_block`` / ``block_apply``).

Counterpart of the reference's ``models/blocks.py`` for kinds ``"dense"``
and ``"moe"``: pre-norm attention, then the pre-norm SwiGLU MLP (dense)
or the routed-expert FFN (moe, ``models/moe.py``), each added to the
residual stream in the compute dtype.  The reference's sharding
constraints are no-ops on one device and are dropped.  The other kinds
(ssm1, ssm2, enc, dec) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import Attention, attention_apply
from repro_torch.models.layers import MLP, Norm, mlp_apply, norm_apply
from repro_torch.models.moe import MoE, moe_apply

KINDS = ("dense", "moe")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP, queue 1 item "
            f"7); the port has {KINDS}")


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and ``mlp`` (dense) or ``moe`` (moe)."""

    def __init__(self, cfg: ArchConfig, kind: str = "dense", *,
                 device="cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_kind(kind)
        dt = cfg.param_dtype
        kw = dict(device=device, generator=generator)
        self.ln1 = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
        self.attn = Attention(cfg, **kw)
        self.ln2 = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
        if kind == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype=dt, **kw)


def init_block(cfg: ArchConfig, kind: str = "dense", *, device="cpu",
               generator: Optional[torch.Generator] = None) -> Block:
    """One layer's parameters (``kind`` is ``"dense"`` or ``"moe"``)."""
    return Block(cfg, kind, device=device, generator=generator)


def block_apply(p: Block, h: torch.Tensor, cfg: ArchConfig, kind: str, *,
                positions=None, cache: Optional[dict] = None,
                cache_index=None, cache_len=None, causal: bool = True):
    """Returns (h, cache_or_None); a cache is updated in place."""
    _check_kind(kind)
    hn = norm_apply(cfg.norm, p.ln1, h)
    a, cache = attention_apply(p.attn, hn, cfg, causal=causal,
                               positions=positions, kv_cache=cache,
                               cache_index=cache_index, cache_len=cache_len)
    h = h + a
    hn = norm_apply(cfg.norm, p.ln2, h)
    if kind == "moe":
        f = moe_apply(p.moe, hn, cfg)
    else:
        f = mlp_apply(p.mlp, hn, cfg.compute_dtype)
    return h + f, cache
