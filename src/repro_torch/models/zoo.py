"""Model assembly: init, forward, logits, KV caches and the decode step,
for the dense and MoE families.

Counterpart of the reference's ``models/zoo.py``:

    model         = init_model(cfg, seed_or_generator, device=...)
    h             = forward(model, cfg, batch)          # final hidden states
    loss, metrics = loss_fn(model, cfg, batch)          # train
    caches        = init_cache(cfg, batch, max_len, device=...)
    logits, cache = decode_step(model, cfg, batch, caches, cache_index=i)

The reference scans stacked layer params; the port keeps one module per
layer in an ``nn.ModuleList`` and loops over it, and where the reference
wraps the scanned layer in ``jax.checkpoint`` (remat), the port runs each
layer under ``torch.utils.checkpoint``.  A MoE config with
``moe.first_dense_layers`` (DeepSeek) has those leading dense layers in
``dense_layers`` (``d_ff = d_first_dense_ff``), run before ``layers``.
The KV cache keeps the reference's stacked layout ({"layers": {"k", "v"}:
[L, B, max_len, KV, D]}, and "dense_layers" likewise) and each layer
updates its slice in place.  The other families (ssm, hybrid, audio,
vlm) and MLA are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models.attention import check_supported
from repro_torch.models.blocks import block_apply, init_block
from repro_torch.models.layers import (Dense, Embedding, Norm, embedding_apply,
                                       norm_apply, torch_dtype)


def check_family(cfg: ArchConfig) -> None:
    """Raise for the configurations the port cannot build yet."""
    if cfg.family not in ("dense", "moe") or cfg.is_encdec \
            or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP, "
            f"queue 1 item 7); the port has the dense and moe families")
    check_supported(cfg)


def _family_block_kind(cfg: ArchConfig) -> str:
    return "moe" if cfg.family == "moe" else "dense"


def _n_dense_layers(cfg: ArchConfig) -> int:
    """DeepSeek's leading dense layers (0 for every other config)."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def _dense_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, d_ff=cfg.moe.d_first_dense_ff)


def _stacks(params: "Model", cfg: ArchConfig) -> list:
    """(cache key, layers, their config, block kind) in the order run."""
    out = []
    if params.dense_layers is not None:
        out.append(("dense_layers", params.dense_layers, _dense_cfg(cfg),
                    "dense"))
    out.append(("layers", params.layers, cfg, _family_block_kind(cfg)))
    return out


# ==========================================================================
# init
# ==========================================================================
class Model(nn.Module):
    """Parameters of a dense or MoE decoder; attribute names are the
    reference's tree keys (``embed``, ``final_norm``, ``lm_head``,
    ``dense_layers``, ``layers``)."""

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
        n_dense = _n_dense_layers(cfg)
        self.dense_layers = (nn.ModuleList(
            init_block(_dense_cfg(cfg), "dense", **kw)
            for _ in range(n_dense)) if n_dense else None)
        kind = _family_block_kind(cfg)
        self.layers = nn.ModuleList(init_block(cfg, kind, **kw)
                                    for _ in range(cfg.n_layers - n_dense))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_model(cfg: ArchConfig,
               generator: Union[int, torch.Generator, None] = 0, *,
               device="cuda") -> Model:
    """Random weights with the reference's shapes and scales (normal
    embeddings x 0.02, normal / sqrt(d_in) projections and experts, unit
    norms), drawn from ``generator``: a seed (a CPU generator seeded with
    it) or a ``torch.Generator``.  A CPU generator draws on the host and
    copies; a CUDA generator draws on its card (``device`` must name that
    card), which a full-width MoE model needs to be built in seconds.
    The draws differ from ``jax.random``'s, and the CPU's from the
    card's; carry the reference's weights across with
    :func:`repro_torch.models.convert.params_from_numpy`."""
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
                caches=None, cache_index=None, cache_len=None,
                remat: bool = False):
    """The layer stacks (``dense_layers``, then ``layers``).  With
    ``remat`` each layer runs under ``checkpoint``: its activations are
    dropped after the forward and recomputed in the backward, so the
    forward kernel of its attention runs twice per training step."""
    for key, stack, scfg, kind in _stacks(params, cfg):
        for i, layer in enumerate(stack):
            if remat:
                h = checkpoint(_layer, layer, h, scfg, kind, positions,
                               use_reentrant=False)
                continue
            cache = None
            if caches is not None:
                cache = {n: c[i] for n, c in caches[key].items()}
            h, _ = block_apply(layer, h, scfg, kind, positions=positions,
                               cache=cache, cache_index=cache_index,
                               cache_len=cache_len)
    return h


def _layer(layer, h, cfg: ArchConfig, kind: str, positions):
    return block_apply(layer, h, cfg, kind, positions=positions)[0]


def forward(params: Model, cfg: ArchConfig, batch: dict, *,
            remat: bool = True) -> torch.Tensor:
    """Returns final hidden states [B, S, d] (final norm applied)."""
    h = _embed_inputs(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _run_layers(params, cfg, h, positions=positions, remat=remat)
    return norm_apply(cfg.norm, params.final_norm, h)


# ==========================================================================
# Loss (token-chunked cross-entropy; never materialises full [T, V] logits)
# ==========================================================================
#: per-chip logits budget of one chunk, in bytes (the reference's)
LOGITS_BUDGET = 256e6


def loss_chunks(batch: int, seq: int, vocab: int, chips: float = 1.0) -> int:
    """The reference's chunk count: the f32 logits of the whole batch over
    a 256e6-byte budget, rounded up to a power of two below S, then halved
    until it divides S.  The port runs on one device (``chips`` 1)."""
    logits_bytes = batch * seq * vocab * 4.0 / chips
    want = max(1, int(-(-logits_bytes // LOGITS_BUDGET)))
    n_chunk = 1
    while n_chunk < want and n_chunk < seq:
        n_chunk *= 2
    while seq % n_chunk:
        n_chunk //= 2
    return n_chunk


def _chunk_loss(hc: torch.Tensor, tc: torch.Tensor, w: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    logits = torch.matmul(hc.to(compute_dtype), w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, tc.long()[:, :, None], dim=-1)[..., 0]
    return torch.sum(lse - gold)


def loss_fn(params: Model, cfg: ArchConfig, batch: dict, *,
            remat: bool = True) -> tuple:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets"}:
    [B, S] on the model's device) -> ``(loss, {"loss", "tokens"})``, 0-d
    f32 tensors.  The vocab projection runs over sequence chunks
    (:func:`loss_chunks`), each under ``checkpoint``, so the backward
    holds one chunk's [B, S/n, V] f32 logits at a time; the reference
    sums its chunks in a ``lax.scan``.  With tied embeddings the table
    takes its gradient from both uses."""
    h = forward(params, cfg, batch, remat=remat)
    B, S, _ = h.shape
    targets = batch["targets"]
    cd = torch_dtype(cfg.compute_dtype)
    w = (params.embed.table.T if cfg.tie_embeddings
         else params.lm_head.w).to(cd)  # [d, vocab]
    n_chunk = loss_chunks(B, S, cfg.vocab)
    s_chunk = S // n_chunk
    acc = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunk):
        cut = slice(i * s_chunk, (i + 1) * s_chunk)
        acc = acc + checkpoint(_chunk_loss, h[:, cut], targets[:, cut], w,
                               cd, use_reentrant=False)
    T = B * S
    loss = acc / T
    return loss, {"loss": loss,
                  "tokens": torch.tensor(float(T), device=h.device)}


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
    over the layers of each stack (the reference returns
    ShapeDtypeStructs): {"dense_layers" (if any), "layers"}: {"k", "v"}."""
    check_family(cfg)
    kv_eff = cfg.n_kv_heads * cfg.kv_repeat
    cd = torch_dtype(cfg.compute_dtype)
    n_dense = _n_dense_layers(cfg)

    def stack(n):
        shape = (n, batch, max_len, kv_eff, cfg.head_dim)
        return {"k": torch.empty(shape, dtype=cd, device="meta"),
                "v": torch.empty(shape, dtype=cd, device="meta")}

    specs = {"dense_layers": stack(n_dense)} if n_dense else {}
    specs["layers"] = stack(cfg.n_layers - n_dense)
    return specs


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    dev = resolve_device(device)
    return {key: {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                  for n, t in stack.items()}
            for key, stack in init_cache_specs(cfg, batch, max_len).items()}


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
    h = _run_layers(params, cfg, h, positions=positions, caches=caches,
                    cache_index=idx, cache_len=idx + S_in)
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
    memory, no draws).  With ``active_only`` the routed experts
    (``w_gate``, ``w_up``, ``w_down``) count at ``top_k / n_routed``, as
    in the reference; dense models have no inactive experts."""
    model = Model(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    if not active_only or cfg.moe is None:
        return total
    expert = sum(p.numel() for name, p in model.named_parameters()
                 if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"))
    active_frac = cfg.moe.top_k / cfg.moe.n_routed
    return int(total - expert + expert * active_frac)
