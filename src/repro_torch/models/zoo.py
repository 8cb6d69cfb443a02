"""Model assembly: init, forward, logits, decode caches and the decode
step, for every family of the zoo: dense, MoE (DeepSeek's MLA included),
SSM (Mamba-1), hybrid (Zamba2), encoder-decoder (audio: SeamlessM4T) and
VLM (InternVL2's backbone with its patch projector).

Counterpart of the reference's ``models/zoo.py``:

    model         = init_model(cfg, seed_or_generator, device=...)
    h             = forward(model, cfg, batch)          # final hidden states
    loss, metrics = loss_fn(model, cfg, batch)          # train
    caches        = init_cache(cfg, batch, max_len, device=...)
    logits, cache = decode_step(model, cfg, batch, caches, cache_index=i,
                                enc_out=None)
    enc_out       = encode_frames(model, cfg, frames)  # encoder-decoder
    specs         = input_specs(cfg, shape)             # meta stand-ins

The reference scans stacked layer params; the port keeps one module per
layer in an ``nn.ModuleList`` and loops over it, and where the reference
wraps the scanned layer in ``jax.checkpoint`` (remat), the port runs each
layer under ``torch.utils.checkpoint``.  A MoE config with
``moe.first_dense_layers`` (DeepSeek) has those leading dense layers in
``dense_layers`` (``d_ff = d_first_dense_ff``), run before ``layers``.
The hybrid (Zamba2) stack runs its Mamba-2 layers in order and, after
every ``shared_attn_every``-th, the one ``shared_attn`` block on
``concat(h, emb0)`` at twice the width, as the reference's
[every-layer scan -> shared attn] x n_sites + trailing layers; under
remat only the Mamba layers are checkpointed, as in the reference.
The decode cache keeps the reference's stacked layout: {"layers": {"k",
"v"}: [L, B, max_len, KV, D]} (and "dense_layers" likewise) for GQA
attention, {"c_kv": [L, B, max_len, r], "k_rope": [L, B, max_len, dr]}
for MLA, under ``kv_cache_quant`` int8 "k", "v" (or "c_kv") with bf16
per-row scales "k_scale", "v_scale" (or "c_kv_scale"), {"layers":
{"conv", "ssm"}} (Mamba-1) or {"layers": {"conv_x", "conv_B", "conv_C",
"ssm"}} (Mamba-2) stacked over L, and for the hybrid also {"shared":
{"k", "v"}} stacked over its call sites.  Each layer writes its slice in
place.

On a mesh (``ctx.use_sharding(rules, mesh)`` with ``mesh`` built by
``launch.mesh.init_mesh``, the parameters made DTensors by
``distributed.sharding.shard_model``) these functions take this rank's
rows of the batch, each layer computes with its parameters' local tensors
(``parallel.local_params``: gathered, or this rank's heads, ``d_ff``
columns or experts), a DTensor cache is read and written through its
local blocks, and ``loss_fn`` returns the loss of the whole batch (summed
over the batch axes, its chunk count the reference's for the mesh's
chips).  The logits a decode step returns are this rank's rows.

The encoder-decoder family has ``enc_layers`` (run unmasked over the
frame embeddings, positions ``arange(Se)``), ``enc_norm`` and
``dec_layers`` (causal self-attention, then cross-attention over the
encoder's output ``enc_out``), and no ``layers``; its cache is {"dec":
{"k", "v"}} stacked over the decoder layers, and a decode step takes
``enc_out`` as an argument or from ``batch["enc_out"]``.  The VLM family
is a dense decoder with a ``projector`` (``fc1``, the tanh GELU, ``fc2``)
that maps a batch's ``patch_embeds`` [B, n_img, frontend_dim] into the
model's width, ahead of the text tokens; its loss drops the image
positions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import parallel
from repro_torch.distributed.ctx import (current_mesh, current_rules,
                                         use_sharding)
from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models.attention import (KV_SHARD, Attention, KVShard,
                                          attention_apply, check_supported)
from repro_torch.models.blocks import SSM_KINDS, block_apply, init_block
from repro_torch.models.layers import (MLP, Dense, Embedding, Norm,
                                       dense_apply, embedding_apply, gelu,
                                       mlp_apply, norm_apply, torch_dtype)
from repro_torch.models.ssm import mamba1_state_specs, mamba2_state_specs


FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_family(cfg: ArchConfig) -> None:
    """Raise for the configurations the port cannot build: a family
    outside the zoo's (``ValueError``), or an attention variant not ported
    yet (``NotImplementedError``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"zoo has {FAMILIES}")
    check_supported(cfg)


def _family_block_kind(cfg: ArchConfig) -> str:
    if cfg.family in ("ssm", "hybrid"):
        return "ssm1" if cfg.ssm.kind == "mamba1" else "ssm2"
    return "moe" if cfg.family == "moe" else "dense"


def _wide_cfg(cfg: ArchConfig) -> ArchConfig:
    """Zamba2's shared block runs at 2 * d_model."""
    d2 = 2 * cfg.d_model
    return dataclasses.replace(cfg, d_model=d2, head_dim=d2 // cfg.n_heads)


def _hybrid_sites(cfg: ArchConfig) -> tuple[int, int]:
    """(call sites of the shared block, trailing Mamba layers)."""
    every = cfg.hybrid.shared_attn_every
    n_sites = cfg.n_layers // every
    return n_sites, cfg.n_layers - n_sites * every


def _n_dense_layers(cfg: ArchConfig) -> int:
    """DeepSeek's leading dense layers (0 for every other config)."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def _dense_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, d_ff=cfg.moe.d_first_dense_ff)


def _stacks(params: "Model", cfg: ArchConfig) -> list:
    """(cache key, layers, their config, block kind) of the decoder, in
    the order run."""
    if cfg.is_encdec:
        return [("dec", params.dec_layers, cfg, "dec")]
    out = []
    if params.dense_layers is not None:
        out.append(("dense_layers", params.dense_layers, _dense_cfg(cfg),
                    "dense"))
    out.append(("layers", params.layers, cfg, _family_block_kind(cfg)))
    return out


# ==========================================================================
# init
# ==========================================================================
class SharedAttn(nn.Module):
    """Zamba2's shared attention block at 2 * d_model: ``ln1``, ``attn``,
    ``ln2``, ``mlp`` and ``out_proj`` back to d_model
    (``_init_shared_attn``)."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        wide = _wide_cfg(cfg)
        d2, dt = wide.d_model, cfg.param_dtype
        kw = dict(device=device, generator=generator)
        self.ln1 = Norm(cfg.norm, d2, dtype=dt, device=device)
        self.attn = Attention(wide, **kw)
        self.ln2 = Norm(cfg.norm, d2, dtype=dt, device=device)
        self.mlp = MLP(d2, cfg.d_ff, dtype=dt, **kw)
        self.out_proj = Dense(d2, cfg.d_model, dtype=dt, **kw)


def _shared_attn_apply(p: SharedAttn, h, emb0, cfg: ArchConfig, *,
                       positions=None, cache=None, cache_index=None,
                       cache_len=None):
    """``h + out_proj(block(concat(h, emb0)))``: a causal prefill's
    attention runs through the ``flash_attention`` kernel at the wide
    config (G = 1); the KV cache is written in place."""
    wide = _wide_cfg(cfg)
    cd = cfg.compute_dtype
    x = torch.cat([h, emb0], dim=-1)
    xn = norm_apply(cfg.norm, p.ln1, x)
    a, cache = attention_apply(p.attn, xn, wide, causal=True,
                               positions=positions, kv_cache=cache,
                               cache_index=cache_index, cache_len=cache_len)
    x = x + a
    xn = norm_apply(cfg.norm, p.ln2, x)
    x = x + mlp_apply(p.mlp, xn, cd)
    return h + dense_apply(p.out_proj, x, cd), cache


class Projector(nn.Module):
    """The VLM's patch projector: ``fc1`` (frontend_dim -> d_model) and
    ``fc2`` (d_model -> d_model), both with a bias."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=cfg.param_dtype, device=device, generator=generator,
                  bias=True)
        self.fc1 = Dense(cfg.frontend_dim, cfg.d_model, **kw)
        self.fc2 = Dense(cfg.d_model, cfg.d_model, **kw)


class Model(nn.Module):
    """Parameters of a model; attribute names are the reference's tree
    keys (``embed``, ``final_norm``, ``lm_head``, ``dense_layers``,
    ``layers``, ``shared_attn``, ``projector``; an encoder-decoder's
    ``enc_layers``, ``enc_norm`` and ``dec_layers`` in place of
    ``layers``)."""

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
        self.enc_layers = self.enc_norm = self.dec_layers = None
        self.dense_layers = self.layers = self.shared_attn = None
        self.projector = None
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(
                init_block(cfg, "enc", **kw) for _ in range(cfg.enc_layers))
            self.enc_norm = Norm(cfg.norm, cfg.d_model, dtype=dt,
                                 device=device)
            self.dec_layers = nn.ModuleList(
                init_block(cfg, "dec", **kw) for _ in range(cfg.n_layers))
            return
        n_dense = _n_dense_layers(cfg)
        self.dense_layers = (nn.ModuleList(
            init_block(_dense_cfg(cfg), "dense", **kw)
            for _ in range(n_dense)) if n_dense else None)
        kind = _family_block_kind(cfg)
        self.layers = nn.ModuleList(init_block(cfg, kind, **kw)
                                    for _ in range(cfg.n_layers - n_dense))
        self.shared_attn = (SharedAttn(cfg, **kw) if cfg.family == "hybrid"
                            else None)
        self.projector = (Projector(cfg, **kw) if cfg.frontend == "patch"
                          else None)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_model(cfg: ArchConfig,
               generator: Union[int, torch.Generator, None] = 0, *,
               device="cuda") -> Model:
    """Random weights with the reference's shapes and scales (normal
    embeddings x 0.02, normal / sqrt(d_in) projections and experts,
    normal x 0.1 SSM convs, unit norms; the SSM's set leaves equal the
    reference's), drawn from ``generator``: a seed (a CPU generator
    seeded with it) or a ``torch.Generator``.  A CPU generator draws on the host and
    copies; a CUDA generator draws on its card (``device`` must name that
    card), which a full-width MoE model needs to be built in seconds.
    The draws differ from ``jax.random``'s, and the CPU's from the
    card's; carry the reference's weights across with
    :func:`repro_torch.models.convert.params_from_numpy`.  On
    ``device="meta"`` nothing is drawn: the model has its shapes and
    dtypes only, for a FLOP count (``launch/analytic_cost.py``)."""
    dev = resolve_device(device, meta=True)
    if dev.type == "meta":
        return Model(cfg, device=dev)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator or 0))
    return Model(cfg, device=dev, generator=generator)


# ==========================================================================
# forward / logits
# ==========================================================================
def _embed_inputs(params: Model, cfg: ArchConfig, batch: dict):
    """Token embeddings, and for the VLM with ``patch_embeds`` in the
    batch the projected patch embeddings ahead of them (image tokens lead
    the sequence)."""
    cd = cfg.compute_dtype
    h = embedding_apply(params.embed, batch["tokens"], cd)
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(torch_dtype(cd))
        pe = dense_apply(params.projector.fc1, pe, cd)
        pe = dense_apply(params.projector.fc2, gelu(pe), cd)
        h = torch.cat([pe, h], dim=1)
    return h


def _run_layers(params: Model, cfg: ArchConfig, h, *, positions,
                caches=None, cache_index=None, cache_len=None, enc_out=None,
                remat: bool = False):
    """The layer stacks (``dense_layers``, then ``layers``, with the
    hybrid's shared block after every ``shared_attn_every``-th layer; an
    encoder-decoder's ``dec_layers``, over ``enc_out``).
    With ``remat`` each layer of the stacks runs under ``checkpoint``: its
    activations are dropped after the forward and recomputed in the
    backward, so the forward kernel of its attention runs twice per
    training step; the shared block is not checkpointed."""
    emb0 = h
    every = cfg.hybrid.shared_attn_every if cfg.family == "hybrid" else 0
    for key, stack, scfg, kind in _stacks(params, cfg):
        for i, layer in enumerate(stack):
            if remat:
                h = checkpoint(_layer, layer, h, scfg, kind, positions,
                               enc_out, True, _sharding(),
                               use_reentrant=False)
            else:
                cache = _cache_slice(caches, key, i)
                with _layer_params(layer, scfg):
                    h, new = block_apply(layer, h, scfg, kind,
                                         positions=positions, cache=cache,
                                         cache_index=cache_index,
                                         cache_len=cache_len,
                                         enc_out=enc_out)
                if cache is not None and kind in SSM_KINDS:
                    for n, t in new.items():  # the new state, in place
                        cache[n].copy_(t)
            if every and (i + 1) % every == 0:
                site = (i + 1) // every - 1
                h, _ = _shared_attn_apply(
                    params.shared_attn, h, emb0, cfg, positions=positions,
                    cache=_cache_slice(caches, "shared", site),
                    cache_index=cache_index, cache_len=cache_len)
    return h


def _cache_slice(caches, key: str, i: int):
    """Entry ``i`` of each stacked tensor of ``caches[key]`` (views), or
    None without caches.  Of a DTensor cache the views are of this rank's
    block, and an attention cache split over a mesh axis says how under
    :data:`KV_SHARD`."""
    if caches is None:
        return None
    out = {n: parallel.local_tensor(c)[i] for n, c in caches[key].items()}
    shard = _kv_shard(caches[key].get("k"))
    if shard is not None:
        out[KV_SHARD] = shard
    return out


def _kv_shard(k) -> Optional[KVShard]:
    """The placement over the model axis of a stacked DTensor k cache
    [L, B, S, KV, D] (``sharding.cache_pspec``): by sequence, KV heads or
    head width; None for a cache whole on every rank of that axis."""
    from torch.distributed.tensor import Shard

    if not parallel.is_dtensor(k):
        return None
    names = k.device_mesh.mesh_dim_names
    for axis, pl in zip(names, k.placements):
        g = parallel.axis_group(axis)
        if g is not None and isinstance(pl, Shard) and pl.dim >= 2:
            return KVShard({2: "seq", 3: "heads", 4: "hd"}[pl.dim], g)
    return None


def _layer_params(layer, cfg: ArchConfig):
    """``parallel.local_params`` of one layer under a mesh; nothing
    without one."""
    if current_mesh() is None:
        return contextlib.nullcontext()
    return parallel.local_params(layer, cfg)


def _top_params(params):
    """The parameters outside the layer stacks, swapped for their local
    tensors under a mesh (the layers are swapped one at a time)."""
    if current_mesh() is None:
        return contextlib.nullcontext()
    return parallel.local_params(params, skip=(
        "layers", "dense_layers", "enc_layers", "dec_layers"))


def _sharding() -> Optional[tuple]:
    """The installed ``(rules, mesh)``, or None: a checkpointed layer
    takes it along, since its recomputation runs in the backward, which
    autograd may run on another thread (a CUDA device's), where the
    thread-local context is not installed."""
    mesh = current_mesh()
    return None if mesh is None else (current_rules(), mesh)


def _layer(layer, h, cfg: ArchConfig, kind: str, positions, enc_out=None,
           causal: bool = True, sharding: Optional[tuple] = None):
    scope = (contextlib.nullcontext() if sharding is None
             else use_sharding(*sharding))
    with scope, _layer_params(layer, cfg):
        return block_apply(layer, h, cfg, kind, positions=positions,
                           enc_out=enc_out, causal=causal)[0]


def encode_frames(params: Model, cfg: ArchConfig, frames: torch.Tensor, *,
                  remat: bool = False) -> torch.Tensor:
    """The encoder stack over (stub) frame embeddings [B, Se, d] on the
    model's device, unmasked, positions ``arange(Se)``, then ``enc_norm``
    -> ``enc_out`` [B, Se, d] in the compute dtype.  Its attention runs the
    ``flash_attention`` kernel on a CUDA device, once a layer."""
    h = frames.to(torch_dtype(cfg.compute_dtype))
    positions = torch.arange(h.shape[1], device=h.device)
    for layer in params.enc_layers:
        if remat:
            h = checkpoint(_layer, layer, h, cfg, "enc", positions, None,
                           False, _sharding(), use_reentrant=False)
        else:
            h = _layer(layer, h, cfg, "enc", positions, None, False)
    with _top_params(params):
        return norm_apply(cfg.norm, params.enc_norm, h)


def forward(params: Model, cfg: ArchConfig, batch: dict, *,
            remat: bool = True) -> torch.Tensor:
    """Returns final hidden states [B, S, d] (final norm applied): for
    the VLM with ``patch_embeds`` S counts the image tokens; for the
    encoder-decoder the decoder's over ``batch["frames"]`` encoded."""
    enc_out = (encode_frames(params, cfg, batch["frames"], remat=remat)
               if cfg.is_encdec else None)
    with _top_params(params):
        h = _embed_inputs(params, cfg, batch)
        positions = torch.arange(h.shape[1], device=h.device)
        h = _run_layers(params, cfg, h, positions=positions, enc_out=enc_out,
                        remat=remat)
        return norm_apply(cfg.norm, params.final_norm, h)


# ==========================================================================
# Loss (token-chunked cross-entropy; never materialises full [T, V] logits)
# ==========================================================================
#: per-chip logits budget of one chunk, in bytes (the reference's)
LOGITS_BUDGET = 256e6


def loss_chunks(batch: int, seq: int, vocab: int, chips: float = 1.0) -> int:
    """The reference's chunk count: the f32 logits of the whole batch over
    a 256e6-byte budget per chip (``chips`` the mesh's size, 1 on one
    device), rounded up to a power of two below S, then halved until it
    divides S."""
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
    [B, S] on the model's device, with the VLM's ``patch_embeds`` or the
    encoder-decoder's ``frames``) -> ``(loss, {"loss", "tokens"})``, 0-d
    f32 tensors; the VLM's image positions carry no loss.  The vocab projection runs over sequence chunks
    (:func:`loss_chunks`), each under ``checkpoint``, so the backward
    holds one chunk's [B, S/n, V] f32 logits at a time; the reference
    sums its chunks in a ``lax.scan``.  With tied embeddings the table
    takes its gradient from both uses.  On a mesh ``batch`` is this
    rank's rows and the loss is the whole batch's: each rank's sum over
    its tokens, divided by all of them, summed over the batch axes."""
    h = forward(params, cfg, batch, remat=remat)
    targets = batch["targets"]
    if cfg.frontend == "patch":  # image tokens carry no LM loss
        h = h[:, h.shape[1] - targets.shape[1]:]
    B, S, _ = h.shape
    cd = torch_dtype(cfg.compute_dtype)
    mesh, dp = current_mesh(), parallel.batch_groups()
    chips = 1.0 if mesh is None else float(mesh.size)
    for g in dp:  # this rank's rows of the batch
        B *= g.size
    n_chunk = loss_chunks(B, S, cfg.vocab, chips)
    s_chunk = S // n_chunk
    acc = torch.zeros((), dtype=torch.float32, device=h.device)
    with _top_params(params):
        w = (params.embed.table.T if cfg.tie_embeddings
             else params.lm_head.w).to(cd)  # [d, vocab]
        for i in range(n_chunk):
            cut = slice(i * s_chunk, (i + 1) * s_chunk)
            acc = acc + checkpoint(_chunk_loss, h[:, cut], targets[:, cut],
                                   w, cd, use_reentrant=False)
    T = B * S
    loss = parallel.reduce_from(acc / T, *dp)
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
def _attn_cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """One attention layer's cache as {name: (shape, dtype)}: the MLA
    latent and rope key, or GQA's k and v; under ``kv_cache_quant`` the
    latent (or k and v) in int8 with bf16 per-row scales."""
    cd = torch_dtype(cfg.compute_dtype)
    i8, bf = torch.int8, torch.bfloat16
    if cfg.mla is not None:
        latent = (batch, max_len, cfg.mla.kv_lora_rank)
        spec = {"c_kv": (latent, i8 if cfg.kv_cache_quant else cd),
                "k_rope": ((batch, max_len, cfg.mla.qk_rope_head_dim), cd)}
        if cfg.kv_cache_quant:
            spec["c_kv_scale"] = ((batch, max_len), bf)
        return spec
    rows = (batch, max_len, cfg.n_kv_heads * cfg.kv_repeat)
    if cfg.kv_cache_quant:
        return {"k": (rows + (cfg.head_dim,), i8),
                "v": (rows + (cfg.head_dim,), i8),
                "k_scale": (rows, bf), "v_scale": (rows, bf)}
    return {"k": (rows + (cfg.head_dim,), cd),
            "v": (rows + (cfg.head_dim,), cd)}


def init_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache's shapes and dtypes as ``meta`` tensors, stacked
    over the layers of each stack (the reference returns
    ShapeDtypeStructs): {"dense_layers" (if any), "layers"}: an attention
    layer's cache (:func:`_attn_cache_spec`) or the SSM state (conv states
    in the compute dtype, the SSM state in f32), and for the hybrid
    "shared": the attention cache at the wide config, stacked over the
    call sites; for the encoder-decoder {"dec": the decoder's
    self-attention caches} (cross-attention keeps none)."""
    check_family(cfg)
    n_dense = _n_dense_layers(cfg)

    def kv(c: ArchConfig, n: int) -> dict:
        return {name: torch.empty((n,) + shape, dtype=dt, device="meta")
                for name, (shape, dt) in
                _attn_cache_spec(c, batch, max_len).items()}

    if cfg.is_encdec:
        return {"dec": kv(cfg, cfg.n_layers)}

    specs = {"dense_layers": kv(cfg, n_dense)} if n_dense else {}
    n = cfg.n_layers - n_dense
    kind = _family_block_kind(cfg)
    if kind in SSM_KINDS:
        one = (mamba1_state_specs if kind == "ssm1"
               else mamba2_state_specs)(cfg, batch)
        specs["layers"] = {
            name: torch.empty((n,) + t.shape, dtype=t.dtype, device="meta")
            for name, t in one.items()}
    else:
        specs["layers"] = kv(cfg, n)
    if cfg.family == "hybrid":
        specs["shared"] = kv(_wide_cfg(cfg), _hybrid_sites(cfg)[0])
    return specs


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    dev = resolve_device(device, meta=True)
    return {key: {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                  for n, t in stack.items()}
            for key, stack in init_cache_specs(cfg, batch, max_len).items()}


def zero_ssm_state(cfg: ArchConfig, caches: dict) -> None:
    """Zero the SSM and conv state of ``caches`` in place (nothing for an
    attention-only model).  A prefill starts from the state it is given,
    so a cache that served an earlier prompt must be zeroed before the
    next; a KV cache needs no zeroing, since a prefill overwrites the
    positions it reads."""
    if _family_block_kind(cfg) in SSM_KINDS:
        for t in caches["layers"].values():
            t.zero_()


def decode_step(params: Model, cfg: ArchConfig, batch: dict, caches: dict,
                *, cache_index, enc_out=None) -> tuple:
    """batch['tokens']: [B, S_in] on the model's device.  S_in == 1 is one
    decode step; S_in > 1 at ``cache_index`` 0 is a prefill, which returns
    only the last position's logits (the VLM's prefill may lead with
    ``batch["patch_embeds"]``, and S_in counts those positions).  An SSM
    layer starts from the state in ``caches``, as in the reference (zeros
    from :func:`init_cache`).  The encoder-decoder's decoder attends over
    ``enc_out`` [B, Se, d], or ``batch["enc_out"]`` cast to the compute
    dtype when not given.  Returns (logits [B, 1, V] f32, caches), the
    caches updated in place."""
    idx = int(cache_index)
    if cfg.is_encdec and enc_out is None:
        enc_out = batch["enc_out"].to(torch_dtype(cfg.compute_dtype))
    with _top_params(params):
        h = _embed_inputs(params, cfg, batch)
        S_in = h.shape[1]
        positions = torch.arange(S_in, device=h.device) + idx
        h = _run_layers(params, cfg, h, positions=positions, caches=caches,
                        cache_index=idx, cache_len=idx + S_in,
                        enc_out=enc_out)
        h = norm_apply(cfg.norm, params.final_norm, h)
        if S_in > 1:  # prefill: only the last position's logits are needed
            h = h[:, -1:]
        return logits_fn(params, cfg, h), caches


# ==========================================================================
# Input specs
# ==========================================================================
def input_specs(cfg: ArchConfig, shape) -> dict:
    """``meta`` tensors with the shapes and dtypes of every model input of
    ``shape`` (a ``ShapeSpec``: kind, seq_len, global_batch), as the
    reference's ShapeDtypeStructs: for train and prefill the VLM's
    ``patch_embeds`` [B, min(frontend_tokens, S // 4), frontend_dim] f32
    and ``tokens`` [B, S - n_img], the encoder-decoder's ``frames``
    [B, max(S // 4, 1), d_model] f32 and ``tokens`` [B, S], or ``tokens``
    [B, S] (int32), with ``targets`` like ``tokens`` for train; for decode
    ``tokens`` [B, 1] and the encoder-decoder's ``enc_out`` [B, max(S //
    4, 1), d_model] f32."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        n_tok = S
        specs = {}
        if cfg.frontend == "patch":
            n_img = min(cfg.frontend_tokens, S // 4)
            specs["patch_embeds"] = spec((B, n_img, cfg.frontend_dim), f32)
            n_tok = S - n_img
        elif cfg.is_encdec:
            specs["frames"] = spec((B, max(S // 4, 1), cfg.d_model), f32)
        specs["tokens"] = spec((B, n_tok), i32)
        if shape.kind == "train":
            specs["targets"] = spec((B, n_tok), i32)
        return specs
    specs = {"tokens": spec((B, 1), i32)}
    if cfg.is_encdec:
        specs["enc_out"] = spec((B, max(S // 4, 1), cfg.d_model), f32)
    return specs


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
