"""Serving steps: prefill (fill KV caches for a full prompt, return last-token
logits) and decode (one token against the cache).

Counterpart of the reference's ``serve/serve_step.py``, run eagerly (no
jit).  Both go through ``zoo.decode_step``: prefill is the S=prompt_len
case with cache_index=0, whose attention is one ``flash_attention`` launch
per layer on a CUDA device.  Every entry point takes ``device`` (default
``"cuda"``, which raises without a card) and needs the model there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import zoo


def check_device(params: zoo.Model, device) -> torch.device:
    """``device`` resolved (raising if it names an unreachable card), and
    the model's own device."""
    dev = zoo.resolve_device(device)
    have = params.device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"the model is on {have}, not on {dev}")
    return have


def _tokens(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


def make_prefill_step(cfg: ArchConfig, max_len: int, *, device="cuda"):
    """prefill(params, batch) -> (last_logits [B,1,V], caches)."""
    zoo.check_family(cfg)
    zoo.resolve_device(device)

    def prefill(params, batch):
        dev = check_device(params, device)
        tokens = _tokens(batch["tokens"], dev)
        caches = zoo.init_cache(cfg, tokens.shape[0], max_len, device=dev)
        return zoo.decode_step(params, cfg, {"tokens": tokens}, caches,
                               cache_index=0)

    return prefill


def make_decode_step(cfg: ArchConfig, *, device="cuda"):
    """decode(params, caches, batch, index) -> (logits [B,1,V], caches)."""
    zoo.check_family(cfg)
    zoo.resolve_device(device)

    def decode(params, caches, batch, index):
        dev = check_device(params, device)
        return zoo.decode_step(params, cfg,
                               {"tokens": _tokens(batch["tokens"], dev)},
                               caches, cache_index=index)

    return decode


@torch.no_grad()
def greedy_generate(params, cfg: ArchConfig, prompt, *, max_new: int,
                    max_len: Optional[int] = None, enc_out=None,
                    device="cuda") -> torch.Tensor:
    """Host-loop greedy decoding: one prefill, then ``max_new - 1`` decode
    steps.  Returns the new tokens [B, max_new] (int64) on the device."""
    if enc_out is not None:
        raise NotImplementedError("encoder-decoder serving is not ported "
                                  "yet (ROADMAP, queue 1 item 7)")
    zoo.check_family(cfg)
    dev = check_device(params, device)
    prompt = _tokens(prompt, dev)
    B, S0 = prompt.shape
    max_len = max_len or (S0 + max_new)
    caches = zoo.init_cache(cfg, B, max_len, device=dev)
    logits, caches = zoo.decode_step(params, cfg, {"tokens": prompt}, caches,
                                     cache_index=0)
    out = [torch.argmax(logits[:, -1], dim=-1)]
    idx = S0
    for _ in range(max_new - 1):
        logits, caches = zoo.decode_step(params, cfg,
                                         {"tokens": out[-1][:, None]},
                                         caches, cache_index=idx)
        out.append(torch.argmax(logits[:, -1], dim=-1))
        idx += 1
    return torch.stack(out, dim=1)
