"""Per-layer transformer blocks (``init_block`` / ``block_apply``).

Counterpart of the reference's ``models/blocks.py`` for kind ``"dense"``:
pre-norm attention, then the pre-norm SwiGLU MLP, each added to the
residual stream in the compute dtype.  The reference's sharding
constraints are no-ops on one device and are dropped.  The other kinds
(moe, ssm1, ssm2, enc, dec) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import Attention, attention_apply
from repro_torch.models.layers import MLP, Norm, mlp_apply, norm_apply

KINDS = ("dense",)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP, queue 1 item "
            f"10); the port has {KINDS}")


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, kind: str = "dense", *,
                 device="cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_kind(kind)
        dt = cfg.param_dtype
        self.ln1 = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
        self.attn = Attention(cfg, device=device, generator=generator)
        self.ln2 = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype=dt, device=device,
                       generator=generator)


def init_block(cfg: ArchConfig, kind: str = "dense", *, device="cpu",
               generator: Optional[torch.Generator] = None) -> Block:
    """One layer's parameters (``kind`` must be ``"dense"``)."""
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
    h = h + mlp_apply(p.mlp, hn, cfg.compute_dtype)
    return h, cache
