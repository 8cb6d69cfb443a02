"""Host-side data pipeline with straggler mitigation.

A background-threaded prefetcher keeps a bounded queue of ready batches; a
per-batch deadline implements *skip-and-backfill*: if the upstream source
stalls (straggling storage / preprocessing shard), the pipeline substitutes
the most recent ready batch instead of blocking the whole step, and the
skipped batch is consumed later (bounded staleness, counted in stats).

Sources: a synthetic token stream (training examples), and a TASM-backed
stream that decodes tile regions as VLM training crops — the storage manager
feeding the training framework (paper Fig. 2 wired end-to-end).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np


@dataclass
class PrefetchStats:
    produced: int = 0
    consumed: int = 0
    stall_substitutions: int = 0
    max_wait_s: float = 0.0


class PrefetchPipeline:
    """Bounded prefetch + deadline-based straggler substitution."""

    def __init__(self, source: Iterator, *, depth: int = 4,
                 deadline_s: float = 1.0):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._deadline = deadline_s
        self._last: Optional[object] = None
        self._done = threading.Event()
        self.stats = PrefetchStats()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self._source:
                if self._done.is_set():
                    return
                self._q.put(item)
                self.stats.produced += 1
        finally:
            self._q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            item = self._q.get(timeout=self._deadline)
        except queue.Empty:
            # straggler: substitute the last ready batch rather than stall
            if self._last is None:
                item = self._q.get()  # nothing to substitute yet: block
            else:
                self.stats.stall_substitutions += 1
                item = self._last
        self.stats.max_wait_s = max(self.stats.max_wait_s,
                                    time.perf_counter() - t0)
        if item is StopIteration:
            raise StopIteration
        self._last = item
        self.stats.consumed += 1
        return item

    def close(self):
        self._done.set()


def synthetic_token_batches(vocab: int, batch: int, seq: int, *,
                            seed: int = 0, n_batches: Optional[int] = None,
                            structured: bool = True):
    """Seeded LM token stream: targets are inputs shifted by one.

    structured=True emits learnable arithmetic sequences (token_{i+1} =
    token_i + stride mod vocab, random start/stride) so example training
    loss demonstrably falls; structured=False is uniform noise (entropy
    floor log(vocab) — useful for throughput-only runs).
    """
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches is None or i < n_batches:
        if structured:
            start = rng.integers(0, vocab, size=(batch, 1))
            stride = rng.integers(1, 4, size=(batch, 1))
            idx = np.arange(seq + 1)[None, :]
            toks = ((start + stride * idx) % vocab).astype(np.int32)
        else:
            toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        i += 1


def tasm_region_batches(source, labels, *, batch: int, crop: int = 32,
                        frame_step: int = 16, seed: int = 0,
                        video: Optional[str] = None):
    """Stream fixed-size crops of storage-manager object regions (VLM fuel).

    ``source`` is a ``VideoStore`` (pass ``video=``; defaults to the only
    catalog entry) or a legacy ``TASM`` facade.  Each batch:
    {'pixels': [B, crop, crop] float32, 'labels': [B] int32}.
    """
    rng = np.random.default_rng(seed)
    label_ids = {l: i for i, l in enumerate(sorted(labels))}
    if hasattr(source, "add_video"):  # VideoStore engine
        name = video or source.videos()[0]
        store = source.video(name).store

        def scan(label, t_range):
            return (source.scan(name).labels(label)
                    .frames(*t_range).execute())
    else:  # deprecated TASM shim
        store, scan = source.store, source.scan
    n_frames = store.sots[-1].frame_end if store.sots else 0
    while True:
        pixels, ys = [], []
        while len(pixels) < batch:
            f0 = int(rng.integers(0, max(n_frames - frame_step, 1)))
            label = sorted(labels)[int(rng.integers(0, len(labels)))]
            res = scan(label, (f0, f0 + frame_step))
            for _, _, px in res.regions:
                if min(px.shape) < 8:
                    continue
                out = np.zeros((crop, crop), np.float32)
                h, w = min(crop, px.shape[0]), min(crop, px.shape[1])
                out[:h, :w] = px[:h, :w]
                pixels.append(out)
                ys.append(label_ids[label])
                if len(pixels) >= batch:
                    break
        yield {"pixels": np.stack(pixels), "labels": np.asarray(ys, np.int32)}
