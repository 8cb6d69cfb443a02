"""Byte-budgeted, workload-predictive cache of decoded tile arrays.

Decoded tiles are the engine's most expensive artifact: every scan that
touches a SOT pays a tile-stream decode even when an earlier query already
materialized the same pixels.  ``TileCache`` keeps those arrays across
queries, keyed::

    (video, sot_id, epoch, tile_idx)

The ``epoch`` component makes invalidation *structural*: ``TileStore.retile``
bumps the SOT's epoch, so every key minted against the old layout simply
stops being asked for — the cache can never serve pre-retile pixels.  Stale
epochs are additionally purged eagerly (:meth:`invalidate`) so dead entries
do not squat on the byte budget.  This holds for every retile producer
alike: foreground ``VideoStore.retile`` calls, inline policy hooks, and the
background :class:`~repro_torch.core.tuner.PhysicalTuner` all route through the
same epoch-bumping engine path, so a scan racing a background re-tile reads
either the old epoch's pixels or the new one's — never a mix.

Frame-depth semantics: a cached array of ``n`` frames serves any request for
``<= n`` frames as a prefix view.  Decode is GOP-independent and
deterministic, so ``arr[:k]`` is bit-identical to a fresh ``k``-frame decode
of the same tile.  A request for *more* frames than cached is a miss; the
deeper decode then replaces the shallower entry.

Block-coverage semantics (ROI-restricted decode): an entry records which
8x8 blocks of the tile its array actually holds — ``None`` for a full-tile
decode, else the mask that was passed to ``decode_tile(blocks=...)``
(pixels outside it are zero, *not* tile content).  A request hits only if
the entry **covers** it: a full-tile entry serves any sub-ROI request, a
covering ROI entry serves any subset mask (per-block decode is
deterministic, so covered blocks are bit-identical), and a request for
blocks outside the entry's mask is a miss.  On such a miss the scheduler
re-decodes the *union* of the old and new masks at the max of both depths,
so :meth:`put` never shrinks an entry in either dimension — coverage and
depth only ever grow until eviction.

Three workload-predictive behaviours ride on those unchanged semantics,
all selected through :class:`~repro_torch.core.config.CacheConfig`:

- **Block-packed ROI entries** (``block_packed=True``): an ROI entry stores
  only its decoded blocks — a boolean pixel mask plus the packed pixel
  array — instead of the zero-padded full-tile canvas, so the same byte
  budget holds many more subframe entries.  :meth:`get` re-materializes
  the canvas on each hit (zeros outside the mask, exactly the bytes decode
  produced), trading a memcpy for budget; served pixels are bit-identical.
- **Expected-reuse eviction** (``eviction="reuse"``): each resident entry
  counts its re-accesses; the eviction victim is the entry with the lowest
  observed reuse (prioritized-replay-style importance weighting — priority
  proportional to observed re-access frequency), oldest-first as the
  tiebreak.  ``eviction="lru"`` preserves the pre-predictive pure-LRU
  behaviour bit-for-bit (insertion/touch order, ``popitem(last=False)``).
- **Prefetch accounting**: the scheduler's prefetcher (see
  ``core/scheduler.py``) inserts entries with ``put(..., prefetch=True)``.
  Such an insert is strictly bounded — it may only evict entries that were
  never re-accessed (a prefetch never evicts a hotter entry; if that can't
  free enough budget the insert is dropped).  ``prefetch_issued`` counts
  predictively-decoded tiles, ``prefetch_hits`` first demand-hits on a
  prefetched entry, ``prefetch_wasted`` prefetched entries that were
  dropped, evicted, invalidated or replaced without ever serving a hit.

Thread safety: every public method takes the internal lock; returned arrays
are shared read-only views (or freshly-materialized canvases for packed
entries) — callers must not write into them (the executor only crops from
them).
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.config import DEFAULT_CACHE_BYTES, CacheConfig

#: cache key: (video, sot_id, epoch, tile_idx)
TileKey = tuple[str, int, int, int]

#: block coverage: None = full tile, else frozenset of tile-local indices
BlockMask = Optional[frozenset]

__all__ = ["TileCache", "CacheStats", "WorkloadPredictor", "TileKey",
           "BlockMask", "DEFAULT_CACHE_BYTES"]


def _covers(entry_blocks: BlockMask, requested: BlockMask) -> bool:
    """Does an entry holding ``entry_blocks`` serve a request for
    ``requested``?  ``None`` means "the whole tile" on either side."""
    if entry_blocks is None:
        return True
    if requested is None:
        return False
    return requested <= entry_blocks


@dataclass
class _Entry:
    arr: np.ndarray                     # canvas [F,h,w], or packed [F,npx]
    blocks: BlockMask
    n_frames: int
    shape_hw: tuple[int, int]
    mask2d: Optional[np.ndarray]        # bool [h,w] when block-packed
    nbytes: int                         # bytes charged to the budget
    canvas_nbytes: int                  # what a zero-padded canvas costs
    uses: int = 0                       # re-accesses while resident
    prefetched: bool = False            # prefetcher insert, no demand hit yet


@dataclass
class CacheStats:
    """Cumulative counters (monotone except ``bytes_cached``/``entries``/
    ``packed_bytes_saved``, which are live gauges)."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    bytes_cached: int = 0
    entries: int = 0
    prefetch_issued: int = 0
    prefetch_hits: int = 0
    prefetch_wasted: int = 0
    packed_bytes_saved: int = 0
    evictions_by_reason: dict = field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class WorkloadPredictor:
    """Sliding-window detector over the scan stream.

    Fed one ``(video, sot_id)`` pair per observed SOTScan (the tuner's
    workload-log tap, see ``tuner.on_scan``).  Per video it keeps the
    recent *distinct* SOT ids; when the last :attr:`MIN_RUN` of them form
    an arithmetic progression with nonzero stride — a scan sliding its
    window across the video, in either direction — it predicts the next
    ``depth`` SOTs on that line.  Anything else (random access, repeats)
    predicts nothing: prefetch is strictly opt-in evidence-driven work.

    Not thread-safe on its own: the scheduler calls it under its lock.
    """

    MIN_RUN = 3

    def __init__(self, depth: int = 2, history: int = 8):
        self.depth = max(1, int(depth))
        self.history = max(self.MIN_RUN, int(history))
        self._hist: dict[str, deque[int]] = {}

    def observe(self, video: str, sot_id: int) -> tuple[int, ...]:
        """Record one observed SOT scan; return the predicted next SOT ids
        (possibly empty)."""
        h = self._hist.get(video)
        if h is None:
            h = self._hist[video] = deque(maxlen=self.history)
        if h and h[-1] == sot_id:       # warm repeat: no new evidence
            return ()
        h.append(sot_id)
        if len(h) < self.MIN_RUN:
            return ()
        tail = list(h)[-self.MIN_RUN:]
        stride = tail[1] - tail[0]
        if stride == 0 or any(tail[i + 1] - tail[i] != stride
                              for i in range(self.MIN_RUN - 1)):
            return ()
        return tuple(tail[-1] + stride * (i + 1) for i in range(self.depth))

    def reset(self, video: Optional[str] = None) -> None:
        if video is None:
            self._hist.clear()
        else:
            self._hist.pop(video, None)


def _block_mask2d(blocks: frozenset, h: int, w: int) -> np.ndarray:
    """Boolean pixel mask for a set of tile-local row-major 8x8-block
    indices (the codec's block geometry; see ``codec/encode.py``)."""
    grid = np.zeros((h // 8, w // 8), dtype=bool)
    grid.flat[sorted(blocks)] = True
    return np.repeat(np.repeat(grid, 8, axis=0), 8, axis=1)


class TileCache:
    """Thread-safe byte-budgeted cache of decoded tile arrays.

    ``budget_bytes <= 0`` disables the cache: every ``get`` misses and
    ``put`` is a no-op (useful for measuring cold-cache behaviour).
    Construct either with a bare byte budget (legacy surface) or a full
    :class:`~repro_torch.core.config.CacheConfig`.
    """

    def __init__(self, budget_bytes: Optional[int] = None, *,
                 config: Optional[CacheConfig] = None):
        if config is None:
            config = CacheConfig(budget_bytes=budget_bytes)
        elif budget_bytes is not None:
            raise ValueError("pass budget_bytes or config, not both")
        self.config = config.resolve()
        self.budget_bytes = self.config.budget_bytes
        # insertion/touch-ordered entry table.  Named for its legacy role:
        # in "lru" mode its order IS the eviction order; in "reuse" mode it
        # is the recency tiebreak under the importance weights.
        self._lru: OrderedDict[TileKey, _Entry] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        self._bytes = 0
        self._prefetch_issued = 0
        self._prefetch_hits = 0
        self._prefetch_wasted = 0
        self._packed_saved = 0
        self._evictions_by_reason: dict[str, int] = {}

    # ----------------------------------------------------------- entries
    def _make_entry(self, arr: np.ndarray, blocks: BlockMask,
                    prefetched: bool) -> _Entry:
        """Build the storage form of one decoded tile — packed (mask +
        selected pixels) for ROI entries under ``block_packed``, the plain
        canvas otherwise.  Runs outside the lock (the pack is a copy)."""
        n_frames, h, w = arr.shape
        canvas_nbytes = int(arr.nbytes)
        if (self.config.block_packed and blocks is not None
                and h % 8 == 0 and w % 8 == 0):
            mask2d = _block_mask2d(blocks, h, w)
            packed = np.ascontiguousarray(arr[:, mask2d])
            nbytes = int(packed.nbytes + mask2d.nbytes)
            if nbytes < canvas_nbytes:
                return _Entry(arr=packed, blocks=blocks, n_frames=n_frames,
                              shape_hw=(h, w), mask2d=mask2d, nbytes=nbytes,
                              canvas_nbytes=canvas_nbytes,
                              prefetched=prefetched)
        return _Entry(arr=arr, blocks=blocks, n_frames=n_frames,
                      shape_hw=(h, w), mask2d=None, nbytes=canvas_nbytes,
                      canvas_nbytes=canvas_nbytes, prefetched=prefetched)

    @staticmethod
    def _materialize(e: _Entry, n_frames: Optional[int]) -> np.ndarray:
        """The served array: a prefix view of the canvas, or a freshly
        scattered canvas for packed entries (zeros outside the mask — the
        exact bytes a masked decode produces, so serving is bit-identical
        to the unpacked path)."""
        if e.mask2d is None:
            return e.arr if n_frames is None else e.arr[:n_frames]
        n = e.n_frames if n_frames is None else n_frames
        out = np.zeros((n, *e.shape_hw), dtype=e.arr.dtype)
        out[:, e.mask2d] = e.arr[:n]
        return out

    # ------------------------------------------------------------- access
    def get(self, key: TileKey, n_frames: int | None = None,
            blocks: Optional[Iterable[int]] = None) -> np.ndarray | None:
        """Return the cached decode for ``key`` (first ``n_frames`` frames),
        or None.  A cached array shallower than ``n_frames``, or one whose
        block coverage does not include every block in ``blocks``
        (``None`` = the whole tile), is a miss."""
        requested = None if blocks is None else frozenset(blocks)
        with self._lock:
            e = self._lru.get(key)
            if e is None or (n_frames is not None
                             and e.n_frames < n_frames) \
                    or not _covers(e.blocks, requested):
                self._misses += 1
                return None
            self._lru.move_to_end(key)
            self._hits += 1
            e.uses += 1
            if e.prefetched:
                e.prefetched = False
                self._prefetch_hits += 1
            return self._materialize(e, n_frames)

    def coverage(self, key: TileKey) -> Optional[tuple[int, BlockMask]]:
        """Peek an entry's ``(n_frames, blocks)`` coverage without touching
        recency order or hit/miss counters — the scheduler uses it to widen
        a covering-miss re-decode to the union of old and new masks."""
        with self._lock:
            e = self._lru.get(key)
            return None if e is None else (e.n_frames, e.blocks)

    # ------------------------------------------------------------ insert
    def _drop(self, key: TileKey, e: _Entry) -> None:
        """Remove an already-popped entry's accounting (lock held)."""
        self._bytes -= e.nbytes
        self._packed_saved -= e.canvas_nbytes - e.nbytes
        if e.prefetched:
            self._prefetch_wasted += 1

    def _pick_victim(self, exclude: TileKey,
                     prefetch: bool) -> Optional[TileKey]:
        """The next eviction victim (lock held).  ``"lru"`` mode: the
        oldest entry, exactly the legacy ``popitem(last=False)``.
        ``"reuse"`` mode: the lowest observed-reuse weight, oldest first
        among ties.  A prefetch insert may only claim never-re-accessed
        entries (``uses == 0``) in either mode — never a hotter one."""
        best = None
        best_uses = None
        for k, e in self._lru.items():
            if k == exclude:
                continue
            if prefetch and e.uses > 0:
                continue
            if self.config.eviction == "lru" and not prefetch:
                return k
            if best_uses is None or e.uses < best_uses:
                best, best_uses = k, e.uses
                if best_uses == 0 and self.config.eviction == "lru":
                    return best    # lru + prefetch: oldest cold entry
        return best

    def put(self, key: TileKey, arr: np.ndarray,
            blocks: Optional[Iterable[int]] = None, *,
            prefetch: bool = False) -> bool:
        """Insert (or deepen/widen) a decoded tile; evicts entries over
        budget.  Arrays larger than the whole budget are not cached.  An
        entry is only replaced by one that covers it (>= frames AND a
        superset block mask) — a narrower or shallower decode never
        clobbers an entry that can serve more requests.

        ``prefetch=True`` marks a predictive insert: it may only evict
        entries that were never re-accessed, and is dropped (returning
        False, counted as wasted) when that cannot free enough budget."""
        new_blocks = None if blocks is None else frozenset(blocks)
        e = self._make_entry(arr, new_blocks, prefetched=prefetch)
        if e.nbytes > self.budget_bytes:
            if prefetch:
                with self._lock:
                    self._prefetch_wasted += 1
            return False
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                if old.n_frames > e.n_frames \
                        or not _covers(new_blocks, old.blocks):
                    self._lru[key] = old   # keep the wider/deeper entry
                    if prefetch:
                        self._prefetch_wasted += 1
                    return False
                self._drop(key, old)
                # same logical object, deeper/wider bytes: the reuse signal
                # (and a pending prefetch credit) carries across the replace
                e.uses = old.uses
                e.prefetched = old.prefetched if prefetch else False
            self._lru[key] = e
            self._bytes += e.nbytes
            self._packed_saved += e.canvas_nbytes - e.nbytes
            reason = "prefetch" if prefetch else "budget"
            while self._bytes > self.budget_bytes:
                victim = self._pick_victim(exclude=key, prefetch=prefetch)
                if victim is None:
                    # only a hotter population remains and the insert was a
                    # prefetch: the prediction loses, not the residents
                    self._drop(key, self._lru.pop(key))
                    return False
                self._drop(victim, self._lru.pop(victim))
                self._evictions += 1
                self._evictions_by_reason[reason] = \
                    self._evictions_by_reason.get(reason, 0) + 1
            return True

    # ------------------------------------------------------- invalidation
    def invalidate(self, video: str | None = None,
                   sot_id: int | None = None,
                   before_epoch: int | None = None) -> int:
        """Drop entries matching the given components; ``before_epoch``
        keeps entries at or above that epoch (purge-stale).  Returns the
        number of entries dropped."""
        with self._lock:
            doomed = [k for k in self._lru
                      if (video is None or k[0] == video)
                      and (sot_id is None or k[1] == sot_id)
                      and (before_epoch is None or k[2] < before_epoch)]
            for k in doomed:
                self._drop(k, self._lru.pop(k))
            self._invalidations += len(doomed)
            return len(doomed)

    def clear(self) -> int:
        return self.invalidate()

    # ----------------------------------------------------------- prefetch
    def note_prefetch_issued(self, n_tiles: int = 1) -> None:
        """Count ``n_tiles`` predictively-issued tile decodes (called by
        the scheduler's prefetcher when it enqueues the work)."""
        with self._lock:
            self._prefetch_issued += n_tiles

    # --------------------------------------------------------------- stats
    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=self._hits, misses=self._misses,
                              evictions=self._evictions,
                              invalidations=self._invalidations,
                              bytes_cached=self._bytes,
                              entries=len(self._lru),
                              prefetch_issued=self._prefetch_issued,
                              prefetch_hits=self._prefetch_hits,
                              prefetch_wasted=self._prefetch_wasted,
                              packed_bytes_saved=self._packed_saved,
                              evictions_by_reason=dict(
                                  self._evictions_by_reason))

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def __contains__(self, key: TileKey) -> bool:
        with self._lock:
            return key in self._lru
