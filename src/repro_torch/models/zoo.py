"""Model assembly: init, forward, logits, KV caches and the decode step,
for the dense family.

Counterpart of the reference's ``models/zoo.py``:

    model         = init_model(cfg, seed_or_generator, device=...)
    h             = forward(model, cfg, batch)          # final hidden states
    caches        = init_cache(cfg, batch, max_len, device=...)
    logits, cache = decode_step(model, cfg, batch, caches, cache_index=i)

The reference scans stacked layer params; the port keeps one module per
layer in an ``nn.ModuleList`` and loops over it.  The KV cache keeps the
reference's stacked layout ({"layers": {"k", "v"}: [L, B, max_len, KV, D]})
and each layer updates its slice in place.  Families other than dense
(moe, ssm, hybrid, audio, vlm) are not ported yet and raise.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models.attention import check_supported
from repro_torch.models.blocks import block_apply, init_block
from repro_torch.models.layers import (Dense, Embedding, Norm, embedding_apply,
                                       norm_apply, torch_dtype)


def check_family(cfg: ArchConfig) -> None:
    """Raise for the configurations the port cannot build yet."""
    if cfg.family != "dense" or cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP, "
            f"queue 1 item 10); the port has the dense family")
    check_supported(cfg)


# ==========================================================================
# init
# ==========================================================================
class Model(nn.Module):
    """Parameters of a dense decoder; attribute names are the reference's
    tree keys (``embed``, ``final_norm``, ``lm_head``, ``layers``)."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_family(cfg)
        dt = cfg.param_dtype
        kw = dict(device=device, generator=generator)
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=dt, **kw)
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype=dt, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else Dense(cfg.d_model, cfg.vocab, dtype=dt, **kw))
        self.layers = nn.ModuleList(init_block(cfg, "dense", **kw)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_model(cfg: ArchConfig,
               generator: Union[int, torch.Generator, None] = 0, *,
               device="cuda") -> Model:
    """Random weights with the reference's shapes and scales (normal
    embeddings x 0.02, normal / sqrt(d_in) projections, unit norms), drawn
    from ``generator`` (a seed or a CPU ``torch.Generator``).  The draws
    differ from ``jax.random``'s; carry the reference's weights across
    with :func:`repro_torch.models.convert.params_from_numpy`."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator or 0))
    return Model(cfg, device=dev, generator=generator)


# ==========================================================================
# forward / logits
# ==========================================================================
def _embed_inputs(params: Model, cfg: ArchConfig, batch: dict):
    return embedding_apply(params.embed, batch["tokens"], cfg.compute_dtype)


def _run_layers(params: Model, cfg: ArchConfig, h, *, positions,
                caches=None, cache_index=None, cache_len=None):
    for i, layer in enumerate(params.layers):
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i]}
        h, _ = block_apply(layer, h, cfg, "dense", positions=positions,
                           cache=cache, cache_index=cache_index,
                           cache_len=cache_len)
    return h


def forward(params: Model, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Returns final hidden states [B, S, d] (final norm applied)."""
    h = _embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _run_layers(params, cfg, h, positions=positions)
    return norm_apply(cfg.norm, params.final_norm, h)


def logits_fn(params: Model, cfg: ArchConfig,
              h_last: torch.Tensor) -> torch.Tensor:
    cd = torch_dtype(cfg.compute_dtype)
    w = (params.embed.table.T if cfg.tie_embeddings
         else params.lm_head.w)  # [d, vocab]
    return torch.matmul(h_last.to(cd), w.to(cd)).float()


# ==========================================================================
# KV caches + decode
# ==========================================================================
def init_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache's shapes and dtypes as ``meta`` tensors, stacked
    over layers (the reference returns ShapeDtypeStructs)."""
    check_family(cfg)
    kv_eff = cfg.n_kv_heads * cfg.kv_repeat
    shape = (cfg.n_layers, batch, max_len, kv_eff, cfg.head_dim)
    cd = torch_dtype(cfg.compute_dtype)
    return {"layers": {"k": torch.empty(shape, dtype=cd, device="meta"),
                       "v": torch.empty(shape, dtype=cd, device="meta")}}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    dev = resolve_device(device)
    specs = init_cache_specs(cfg, batch, max_len)
    return {"layers": {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                       for n, t in specs["layers"].items()}}


def decode_step(params: Model, cfg: ArchConfig, batch: dict, caches: dict,
                *, cache_index) -> tuple:
    """batch['tokens']: [B, S_in] on the model's device.  S_in == 1 is one
    decode step; S_in > 1 at ``cache_index`` 0 is a prefill, which returns
    only the last position's logits.  Returns (logits [B, 1, V] f32,
    caches), the caches updated in place."""
    idx = int(cache_index)
    h = _embed_inputs(params, cfg, batch)
    S_in = h.shape[1]
    positions = torch.arange(S_in, device=h.device) + idx
    h = _run_layers(params, cfg, h, positions=positions,
                    caches=caches["layers"], cache_index=idx,
                    cache_len=idx + S_in)
    h = norm_apply(cfg.norm, params.final_norm, h)
    if S_in > 1:  # prefill: only the last position's logits are needed
        h = h[:, -1:]
    return logits_fn(params, cfg, h), caches


# ==========================================================================
# Param counting
# ==========================================================================
@functools.lru_cache(maxsize=64)
def analytic_param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of the port's model, built on the ``meta`` device (no
    memory, no draws).  Dense models have no inactive experts, so
    ``active_only`` does not change the count."""
    model = Model(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())
