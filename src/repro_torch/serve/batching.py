"""Continuous batching scheduler (vLLM-style, simplified).

Counterpart of the reference's ``serve/batching.py``, with the same
scheduling: requests arrive with different prompt lengths and token
budgets; the scheduler keeps a fixed number of slots, prefills new requests
into free slots, decodes all active slots in lock-step, and retires
finished ones.  Each slot owns a row of the shared (layer-stacked) KV
cache, which lives on the model's device and is updated in place.

Simplifications vs production (documented, as in the reference): wave
admission (all slots must drain before the next wave — zoo.decode_step
shares one cache index across rows; prompts are left-padded with token 0
to the wave's length, and the padding is attended like any token), greedy
sampling, no prefix sharing.

The encoder-decoder family is refused: the reference's batcher passes no
``enc_out`` to ``decode_step``, which then fails on that family (ROADMAP,
queue 3); the port says so rather than gain a feature the reference
lacks.  Serve it through ``serve_step``.  The VLM serves text prompts, as
in the reference.

One deliberate divergence: at each admission the port zeroes the SSM and
conv state of its caches (``zoo.zero_ssm_state``).  The reference
prefills a new wave into the caches of the last, so its SSM layers start
from the last wave's final state; a KV cache needs no reset, since a
prefill overwrites what it reads.  The port's first wave is the
reference's; each later wave gives what fresh caches would.

Under a mesh (``ctx.use_sharding``, the model placed by ``shard_model``)
the caches are DTensors placed by ``cache_pspec``, each rank prefills and
decodes its rows of the slots, the SSM state is zeroed on each rank's
block, and every rank sees every slot's tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import parallel
from repro_torch.models import zoo
from repro_torch.serve.serve_step import (check_device, init_caches,
                                          next_tokens)


#: why the batcher and the launcher refuse the encoder-decoder family
ENCDEC_REFUSED = (
    "{}: the reference's continuous batcher and serving launcher pass no "
    "enc_out to decode_step (src/repro/serve/batching.py, "
    "src/repro/launch/serve.py), which needs it for the encoder-decoder "
    "family (ROADMAP, queue 3); serve it with make_prefill_step, "
    "make_decode_step and greedy_generate(enc_out=...)")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S0] int32
    max_new: int
    out_tokens: list = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


@dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0  # next cache index for this slot


class ContinuousBatcher:
    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_len: int = 256, device="cuda"):
        zoo.check_family(cfg)
        if cfg.is_encdec:
            raise NotImplementedError(ENCDEC_REFUSED.format(cfg.name))
        self.device = check_device(params, device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.slots = [_Slot() for _ in range(slots)]
        self.caches = init_caches(cfg, slots, max_len, self.device)
        self.queue: list[Request] = []
        self.finished: list[Request] = []

    def _step(self, tokens: np.ndarray, pos: int) -> np.ndarray:
        """One lock-step prefill (``pos`` 0) or decode of all slots (this
        rank's rows under a mesh); every slot's next token."""
        rows = parallel.batch_rows(
            torch.from_numpy(tokens).to(self.device, torch.long))
        logits, self.caches = zoo.decode_step(
            self.params, self.cfg, {"tokens": rows}, self.caches,
            cache_index=pos)
        return parallel.gather_rows(
            next_tokens(self.cfg, logits)).cpu().numpy()

    # -------------------------------------------------------------- intake
    def submit(self, prompt: np.ndarray, max_new: int) -> Request:
        req = Request(len(self.queue) + len(self.finished), np.asarray(prompt),
                      max_new, submitted_at=time.perf_counter())
        self.queue.append(req)
        return req

    def _admit_wave(self):
        """Admit a wave of requests, padded to one prompt length.

        Admission requires ALL slots free: zoo.decode_step advances every
        cache row with one shared index, so slots must stay position-aligned.
        Early finishers idle their slot until the wave drains (iteration-level
        batching)."""
        if any(s.request is not None for s in self.slots):
            return
        free = [s for s in self.slots if s.request is None]
        if not free or not self.queue:
            return
        wave = [self.queue.pop(0)
                for _ in range(min(len(free), len(self.queue)))]
        pad_to = max(len(r.prompt) for r in wave)
        toks = np.zeros((len(self.slots), pad_to), np.int64)
        for slot, req in zip(free, wave):
            slot.request = req
            slot.pos = pad_to
            row = self.slots.index(slot)
            toks[row, -len(req.prompt):] = req.prompt
        zoo.zero_ssm_state(self.cfg, self.caches)
        first = self._step(toks, 0)
        now = time.perf_counter()
        for slot in free:
            if slot.request is None:
                continue
            slot.request.out_tokens.append(int(first[self.slots.index(slot)]))
            slot.request.first_token_at = now

    # -------------------------------------------------------------- stepping
    @torch.no_grad()
    def step(self) -> int:
        """One scheduler tick: admit, decode one token for active slots,
        retire finished.  Returns number of active slots."""
        self._admit_wave()
        active = [i for i, s in enumerate(self.slots) if s.request is not None]
        if not active:
            return 0
        toks = np.zeros((len(self.slots), 1), np.int64)
        for i in active:
            toks[i, 0] = self.slots[i].request.out_tokens[-1]
        pos = min(self.slots[i].pos for i in active)
        nxt = self._step(toks, pos)
        now = time.perf_counter()
        for i in active:
            slot = self.slots[i]
            slot.request.out_tokens.append(int(nxt[i]))
            slot.pos += 1
            done = (len(slot.request.out_tokens) >= slot.request.max_new
                    or slot.pos >= self.max_len - 1)
            if done:
                slot.request.done_at = now
                self.finished.append(slot.request)
                slot.request = None
                slot.pos = 0
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> dict:
        t0 = time.perf_counter()
        ticks = tokens = 0
        while (self.queue or any(s.request for s in self.slots)) \
                and ticks < max_ticks:
            tokens += self.step()
            ticks += 1
        dt = time.perf_counter() - t0
        lat = [r.done_at - r.submitted_at for r in self.finished if r.done_at]
        ttft = [r.first_token_at - r.submitted_at for r in self.finished
                if r.first_token_at]
        return {
            "requests": len(self.finished),
            "ticks": ticks,
            "tokens": tokens,
            "tok_per_s": tokens / dt if dt else 0.0,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
        }
