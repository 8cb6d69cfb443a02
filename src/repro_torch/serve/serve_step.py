"""Serving steps: prefill (fill KV caches for a full prompt, return last-token
logits) and decode (one token against the cache).

Counterpart of the reference's ``serve/serve_step.py``, run eagerly (no
jit).  Both go through ``zoo.decode_step``: prefill is the S=prompt_len
case with cache_index=0, whose attention is one ``flash_attention`` launch
per layer on a CUDA device.  Every entry point takes ``device`` (default
``"cuda"``, which raises without a card) and needs the model there; the
two steps also take ``"meta"``, where they run on shapes alone for a FLOP
count (``launch/analytic_cost.py``).

The encoder-decoder family: the prefill encodes ``batch["frames"]``
first (``zoo.encode_frames``: one more launch per encoder layer, and the
decoder's cross-attention one per decoder layer); a decode step reads
``batch["enc_out"]``, and ``greedy_generate`` takes ``enc_out=``, as in
the reference.  The VLM family: a prefill's batch may lead with
``patch_embeds`` [B, n_img, frontend_dim], which take the first n_img
cache positions, so the decode index that follows it is n_img + the
prompt's length; ``greedy_generate`` takes text prompts only, as the
reference's.

Under a mesh (``ctx.use_sharding(rules, mesh)``, the model's parameters
placed by ``sharding.shard_model(..., mode="serve")``) the two steps take
the whole batch and return every row's logits: each rank runs its rows
(``parallel.batch_rows``), its caches are DTensors placed by
``sharding.cache_pspec`` (``shard_cache``), and the logits are gathered
over the batch axes (and over ``model`` where the vocabulary is split:
:func:`whole_logits`); so does ``greedy_generate``, whose new tokens are
every row's, each the argmax over every rank's vocabulary columns
(``parallel.vocab_argmax``).  The encoder-decoder's ``frames`` and
``enc_out`` and the VLM's ``patch_embeds`` are split by rows as the
tokens are, so each rank encodes its own rows once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import parallel
from repro_torch.distributed.ctx import current_mesh
from repro_torch.distributed.sharding import shard_cache
from repro_torch.models import zoo


def check_device(params: zoo.Model, device) -> torch.device:
    """``device`` resolved (raising if it names an unreachable card), and
    the model's own device."""
    dev = zoo.resolve_device(device, meta=True)
    have = params.device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"the model is on {have}, not on {dev}")
    return have


def _tokens(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


def _floats(x, device: torch.device) -> torch.Tensor:
    """Embeddings on ``device``, in their own float dtype (f32 from
    numpy); the model casts them to its compute dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _inputs(batch: dict, device: torch.device) -> dict:
    """``tokens`` and, where given, ``patch_embeds`` and ``enc_out`` of
    ``batch`` on ``device`` (this rank's rows under a mesh)."""
    out = {"tokens": _tokens(batch["tokens"], device)}
    for name in ("patch_embeds", "enc_out"):
        if name in batch:
            out[name] = _floats(batch[name], device)
    return {k: parallel.batch_rows(v) for k, v in out.items()}


def whole_logits(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Every row's logits over the whole vocabulary from this rank's
    (``zoo.decode_step``'s): gathered over the vocabulary's group, then
    over the batch axes."""
    g = parallel.vocab_group(cfg.vocab)
    return parallel.gather_rows(parallel.gather_from(logits, g, -1))


def next_tokens(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each of this rank's rows from its logits
    [B, 1, V or V/M] (``torch.argmax``'s first maximum)."""
    return parallel.vocab_argmax(logits[:, -1],
                                 parallel.vocab_group(cfg.vocab))


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dev) -> dict:
    """Zeroed decode caches for ``batch`` rows (the whole batch): DTensors
    placed by ``cache_pspec`` under a built mesh, each rank holding its
    block (``meta`` blocks, which hold nothing, where ``dev`` is
    ``meta``)."""
    mesh = current_mesh()
    if mesh is not None and mesh.device_mesh is not None:
        return shard_cache(zoo.init_cache_specs(cfg, batch, max_len), cfg,
                           mesh, device=dev)
    return zoo.init_cache(cfg, batch, max_len, device=dev)


def make_prefill_step(cfg: ArchConfig, max_len: int, *, device="cuda"):
    """prefill(params, batch) -> (last_logits [B,1,V], caches).  batch:
    ``tokens`` [B, S], the VLM's ``patch_embeds`` where given, the
    encoder-decoder's ``frames`` [B, Se, d_model]."""
    zoo.check_family(cfg)
    zoo.resolve_device(device, meta=True)

    def prefill(params, batch):
        dev = check_device(params, device)
        inputs = _inputs(batch, dev)
        caches = init_caches(cfg, len(batch["tokens"]), max_len, dev)
        enc_out = None
        if cfg.is_encdec:
            enc_out = zoo.encode_frames(
                params, cfg,
                parallel.batch_rows(_floats(batch["frames"], dev)))
        logits, caches = zoo.decode_step(params, cfg, inputs, caches,
                                         cache_index=0, enc_out=enc_out)
        return whole_logits(cfg, logits), caches

    return prefill


def make_decode_step(cfg: ArchConfig, *, device="cuda"):
    """decode(params, caches, batch, index) -> (logits [B,1,V], caches).
    The encoder-decoder's batch carries ``enc_out`` [B, Se, d_model]."""
    zoo.check_family(cfg)
    zoo.resolve_device(device, meta=True)

    def decode(params, caches, batch, index):
        dev = check_device(params, device)
        logits, caches = zoo.decode_step(params, cfg, _inputs(batch, dev),
                                         caches, cache_index=index)
        return whole_logits(cfg, logits), caches

    return decode


@torch.no_grad()
def greedy_generate(params, cfg: ArchConfig, prompt, *, max_new: int,
                    max_len: Optional[int] = None, enc_out=None,
                    device="cuda") -> torch.Tensor:
    """Host-loop greedy decoding of text prompts: one prefill, then
    ``max_new - 1`` decode steps.  The encoder-decoder family needs the
    encoder's output ``enc_out`` [B, Se, d_model] (``zoo.encode_frames``),
    which every step attends over.  Returns the new tokens [B, max_new]
    (int64) on the device."""
    zoo.check_family(cfg)
    if cfg.is_encdec != (enc_out is not None):
        raise ValueError(f"{cfg.name}: greedy_generate takes enc_out for "
                         f"the encoder-decoder family, and only for it")
    dev = check_device(params, device)
    prompt = _tokens(prompt, dev)
    B, S0 = prompt.shape
    max_len = max_len or (S0 + max_new)
    caches = init_caches(cfg, B, max_len, dev)
    prompt = parallel.batch_rows(prompt)
    extra = {} if enc_out is None else {
        "enc_out": parallel.batch_rows(_floats(enc_out, dev))}
    logits, caches = zoo.decode_step(params, cfg,
                                     {"tokens": prompt, **extra}, caches,
                                     cache_index=0)
    out = [next_tokens(cfg, logits)]
    idx = S0
    for _ in range(max_new - 1):
        logits, caches = zoo.decode_step(
            params, cfg, {"tokens": out[-1][:, None], **extra}, caches,
            cache_index=idx)
        out.append(next_tokens(cfg, logits))
        idx += 1
    return parallel.gather_rows(torch.stack(out, dim=1))
