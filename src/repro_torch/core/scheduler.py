"""ScanScheduler: merged, cached execution of physical plans (serving
layer, part 2).

The engine's :class:`~repro_torch.core.query.PhysicalPlan` makes every scan an
explicit list of :class:`~repro_torch.core.query.SOTScan` work units, which is
exactly what a scheduler needs:

- **Merge rule** — within a batch, SOTScans from different plans targeting
  the same ``(video, sot_id)`` become one *group fetch*: each member's tile
  needs are resolved against the SOT's **current** layout (stale-epoch plans
  recompute ``tiles_intersecting``, exactly like the old ``_decode_one``),
  the union of tile indices is fetched once through the
  :class:`~repro_torch.core.tile_cache.TileCache`, and every member crops its
  regions from the shared arrays.  A shared ``(sot, tile)`` is therefore
  decoded at most once per batch — and zero times when cached.
- **Worker pool** — group fetches run on one long-lived thread pool shared
  by all callers (the old per-execute pool is gone).
- **Serial-equivalent semantics** — after the parallel fetch phase, each
  plan is *finished* (regions assembled, policy hooks run, history recorded)
  strictly in submission order.  If a policy hook re-tiles a SOT (inline
  tuning mode), the epoch bump makes the batch's group fetch stale; later
  plans in the batch detect the mismatch and re-fetch at the new epoch.
  Per-query regions are thus bit-identical to running the same plans
  through serial ``execute()`` calls, and the cache can never serve
  pre-retile pixels (keys carry the epoch).
- **Policy hooks via the tuner** — the per-SOT hooks are dispatched through
  the engine's :class:`~repro_torch.core.tuner.PhysicalTuner`: under
  ``tuning="inline"`` they observe + retile synchronously here (charged to
  the query's ``retile_s``, preserving the pre-tuner semantics bit-for-bit);
  under ``tuning="background"`` (the default) they only append observations
  to the tuner's bounded workload log, and retiling happens asynchronously
  on the tuner thread — the scan path never pays re-encode latency.
- **Stats attribution** — each query's :class:`ScanStats` reports
  ``cache_hits``/``cache_misses`` over the tiles it needed; a freshly
  decoded tile is charged as a miss to the first plan (submission order)
  that needed it, and as a hit to every later one.

:class:`ServingSession` (``store.serve()``) is the concurrent front end: a
dispatcher thread drains a submission queue and micro-batches whatever is
queued into one ``execute_many`` call, so overlapping scans from concurrent
callers merge without any coordination on their part.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core.layout import BBox, TileLayout, block_coverage
from repro_torch.core.query import (PhysicalPlan, ScanPlan, ScanQuery, ScanResult,
                              ScanStats, SOTScan)
from repro_torch.core.tile_cache import TileCache, WorkloadPredictor

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.engine import VideoStore

#: one decode group: every SOTScan in a batch hitting this (video, sot_id)
GroupKey = tuple[str, int]


def _resolve_needs(ss: SOTScan, rec) -> tuple[tuple[int, ...], dict]:
    """The (tile indices, per-tile block masks) ``ss`` needs under the
    SOT's *current* layout.  Planned values when the epoch still matches;
    recomputed from the requested boxes after a retile (stale plan).  The
    mask dict is empty for full-tile plans (``roi_decode=False``); in an
    ROI plan a mask of ``None`` means every block of that tile."""
    if rec.epoch == ss.epoch:
        return ss.tile_idxs, ss.blocks_by_tile
    if ss.blocks_by_tile:   # ROI plan: recompute coverage under new layout
        bbt = block_coverage(rec.layout, ss.boxes_by_frame)
        return tuple(sorted(bbt)), bbt
    needed: set[int] = set()
    for boxes in ss.boxes_by_frame.values():
        for box in boxes:
            needed.update(rec.layout.tiles_intersecting(box))
    return tuple(sorted(needed)), {}


@dataclass
class _GroupFetch:
    """Decoded state of one group at one epoch."""
    epoch: int
    layout: TileLayout
    tiles: dict[int, np.ndarray]
    fresh: set[int]                       # decoded this fetch (cache misses)
    need: dict[int, tuple[int, ...]]      # id(SOTScan) -> resolved tiles
    pixels_by_tile: dict[int, float] = field(default_factory=dict)
    seconds: float = 0.0                  # wall time of this fetch
    claimed: set[int] = field(default_factory=set)
    time_claimed: bool = False


class ScanScheduler:
    """Executes batches of physical plans with merged, cached decodes.

    One scheduler per :class:`VideoStore`; ``lock`` serializes batches (and
    engine-level retiles), so concurrent callers of ``VideoStore.execute``
    are safe, while *merging* happens for plans submitted together through
    :meth:`execute_many` or a :class:`ServingSession`.
    """

    def __init__(self, engine: "VideoStore", *,
                 max_workers: Optional[int] = None,
                 cache: Optional[TileCache] = None):
        self.engine = engine
        self.cache = cache if cache is not None else TileCache()
        self.max_workers = max_workers or engine.max_decode_workers
        self.lock = threading.RLock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        # predictive prefetch (CacheConfig.prefetch): the tuner's workload
        # tap feeds the predictor; detected sliding windows enqueue decode
        # jobs for the next SOTs on the worker pool (see _prefetch_job)
        self._predictor: Optional[WorkloadPredictor] = None
        self._prefetch_cv = threading.Condition()
        self._prefetch_pending: set[GroupKey] = set()
        self._prefetch_inflight = 0

    # ----------------------------------------------------------- frontend
    def _normalize(self, plan) -> PhysicalPlan:
        if isinstance(plan, ScanQuery):
            plan = plan.plan()
        if isinstance(plan, ScanPlan):
            plan = self.engine.lower(plan)
        if not isinstance(plan, PhysicalPlan):
            raise TypeError(f"cannot execute {type(plan).__name__}; want "
                            "ScanQuery, ScanPlan or PhysicalPlan")
        return plan

    def execute(self, plan) -> ScanResult:
        return self.execute_many([plan])[0]

    def execute_many(self, plans) -> list[ScanResult]:
        """Execute plans as one batch: shared-tile decodes are merged, then
        each plan finishes (assembly + policy hooks) in submission order."""
        pplans = [self._normalize(p) for p in plans]
        with self.lock:
            return self._execute_batch(pplans)

    def session(self, **kw) -> "ServingSession":
        return ServingSession(self, **kw)

    # -------------------------------------------------------------- batch
    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.max_workers,
                    thread_name_prefix="tasm-decode")
            return self._pool

    def offload(self, fn, *args):
        """Run ``fn(*args)`` on the decode worker pool WITHOUT taking the
        batch lock — the serving layer uses this to marshal replies (doc
        building + payload packing) off its dispatcher thread, and those
        jobs must not queue behind in-flight batches.  Returns the
        future.  Like ``execute``, a call after ``shutdown`` re-creates
        the pool on demand; only a submit RACING the shutdown raises
        ``RuntimeError`` (callers fall back to running inline)."""
        return self._ensure_pool().submit(fn, *args)

    def shutdown(self) -> None:
        """Release the worker pool (idempotent; a later batch re-creates
        it on demand)."""
        with self.lock:
            with self._pool_lock:
                pool, self._pool = self._pool, None
            if pool is not None:
                pool.shutdown(wait=True)

    # ----------------------------------------------------------- prefetch
    def note_scan(self, sot_scans: "list[SOTScan]") -> None:
        """Workload tap (called by ``tuner.on_scan`` under the batch lock,
        for EVERY scan regardless of tuning mode or policy): feed the
        sliding-window predictor and enqueue prefetch decode jobs for the
        SOTs it expects next.  No-op unless ``CacheConfig.prefetch``."""
        cfg = self.cache.config
        if not cfg.prefetch or self.cache.budget_bytes <= 0:
            return
        if self._predictor is None:
            self._predictor = WorkloadPredictor(depth=cfg.prefetch_depth)
        for ss in sot_scans:
            for sid in self._predictor.observe(ss.video, ss.sot_id):
                self._maybe_prefetch(ss.video, sid)

    def _maybe_prefetch(self, video: str, sot_id: int) -> None:
        """Enqueue one predicted SOT's decode, single-flight per
        ``(video, sot_id)``; predictions past the end of the video (the
        window sliding off the edge) are dropped here."""
        entry = self.engine._videos.get(video)
        if entry is None or not 0 <= sot_id < len(entry.store.sots):
            return
        gkey = (video, sot_id)
        with self._prefetch_cv:
            if gkey in self._prefetch_pending:
                return
            self._prefetch_pending.add(gkey)
            self._prefetch_inflight += 1
        try:
            self._ensure_pool().submit(self._prefetch_job, video, sot_id)
        except BaseException:
            with self._prefetch_cv:
                self._prefetch_pending.discard(gkey)
                self._prefetch_inflight -= 1
                self._prefetch_cv.notify_all()
            raise

    def _prefetch_job(self, video: str, sot_id: int) -> None:
        """Decode one predicted SOT's tiles (full depth, full blocks — a
        full entry serves ANY later sub-request bit-identically) and admit
        them with ``put(prefetch=True)`` (never evicting a hotter entry).

        Charging: this decode belongs to no query — it never touches a
        ``ScanStats``.  The work lands in the store's decode totals and in
        ``CacheStats.prefetch_issued``; a scan that later hits the entry
        records an ordinary cache hit with zero pixels charged (exactly
        the shared-decode first-consumer rule, with the prefetcher as the
        consumer that already paid).  Epoch safety is structural: entries
        carry the epoch read before the decode, a retile racing us bumps
        it, and we re-check + purge after the puts, so stale pixels are
        never served and never squat on the budget."""
        gkey = (video, sot_id)
        try:
            entry = self.engine._videos.get(video)
            if entry is None or not 0 <= sot_id < len(entry.store.sots):
                return
            rec = entry.store.sots[sot_id]
            epoch = rec.epoch
            n_frames = rec.frame_end - rec.frame_start
            tiles = []
            for t in range(rec.layout.n_tiles):
                cov = self.cache.coverage((video, sot_id, epoch, t))
                if cov is not None and cov[0] >= n_frames and cov[1] is None:
                    continue           # already fully resident
                tiles.append(t)
            if not tiles:
                return
            self.cache.note_prefetch_issued(len(tiles))
            dec = entry.store.decode_tiles(sot_id, tiles, n_frames=n_frames)
            if rec.epoch == epoch:
                for t, arr in dec.items():
                    self.cache.put((video, sot_id, epoch, t), arr,
                                   prefetch=True)
            if rec.epoch != epoch:
                self.cache.invalidate(video, sot_id, before_epoch=rec.epoch)
        except Exception:
            # best-effort by contract: a lost race (drop_video, store-level
            # retile deleting files mid-read) abandons the prediction
            pass
        finally:
            with self._prefetch_cv:
                self._prefetch_pending.discard(gkey)
                self._prefetch_inflight -= 1
                self._prefetch_cv.notify_all()

    def drain_prefetch(self, timeout: Optional[float] = None) -> None:
        """Deterministic prefetch barrier: block until every prefetch job
        enqueued before this call has completed (tests and benchmarks use
        it to make 'the next window is already resident' assertable)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._prefetch_cv:
            while self._prefetch_inflight:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"drain_prefetch timed out with "
                        f"{self._prefetch_inflight} jobs in flight")
                self._prefetch_cv.wait(remaining)

    def _execute_batch(self, pplans: list[PhysicalPlan]) -> list[ScanResult]:
        groups: dict[GroupKey, list[tuple[int, SOTScan]]] = {}
        for i, pp in enumerate(pplans):
            if not pp.logical.decode:
                continue
            for ss in pp.sot_scans:
                groups.setdefault((ss.video, ss.sot_id), []).append((i, ss))

        fetched: dict[GroupKey, _GroupFetch] = {}
        batch_decode_s = 0.0
        if groups:
            keys = sorted(groups)
            t0 = time.perf_counter()
            if len(keys) == 1:
                k = keys[0]
                fetched[k] = self._fetch(k, [ss for _, ss in groups[k]])
            else:
                pool = self._ensure_pool()
                fn = lambda k: self._fetch(k, [ss for _, ss in groups[k]])
                for k, f in zip(keys, pool.map(fn, keys)):
                    fetched[k] = f
            batch_decode_s = time.perf_counter() - t0

        results = [self._finish_one(i, pp, groups, fetched, batch_decode_s,
                                    single_plan=len(pplans) == 1)
                   for i, pp in enumerate(pplans)]
        if self.engine.dirty:
            self.engine.save()
        return results

    def _fetch(self, gkey: GroupKey, members: list[SOTScan]) -> _GroupFetch:
        """Decode one group: union of the members' (current-layout) tile
        needs, each tile through the cache.  Block masks union across
        members, so a shared tile decodes each needed block at most once;
        a cached entry covering a member's mask (full tile, or a superset
        ROI) is a hit, and a covering miss re-decodes the union of the old
        entry's mask and the new need (never shrinking coverage)."""
        t0 = time.perf_counter()
        video, sot_id = gkey
        entry = self.engine.video(video)
        rec = entry.store.sots[sot_id]
        epoch = rec.epoch
        need: dict[int, tuple[int, ...]] = {}
        # per-tile decode depth: the deepest member that needs the tile (a
        # group-wide max would re-decode warm shallow tiles whenever any
        # deeper query shares the group)
        depth: dict[int, int] = {}
        # per-tile block mask: union over members; None = full tile
        masks: dict[int, object] = {}
        stale_seen = False
        for ss in members:
            stale_seen |= ss.epoch != epoch
            tiles, bbt = _resolve_needs(ss, rec)
            need[id(ss)] = tiles
            for t in tiles:
                depth[t] = max(depth.get(t, 0), ss.n_frames)
                m = bbt.get(t) if bbt else None
                if t not in masks:
                    masks[t] = None if m is None else set(m)
                elif masks[t] is not None:
                    masks[t] = None if m is None else masks[t] | set(m)
        for t, m in masks.items():
            # a union that grew to every block IS a full-tile need:
            # normalize to None so the cached entry serves later
            # whole-tile requests too (None covers everything)
            if m is not None and len(m) == rec.layout.tile_blocks(t):
                masks[t] = None
        if stale_seen:
            # a retile outdated this plan; if it was a store-level retile
            # (engine-path ones purge on the spot) dead-epoch entries are
            # still squatting on the byte budget — purge is idempotent
            self.cache.invalidate(video, sot_id, before_epoch=epoch)
        out: dict[int, np.ndarray] = {}
        to_decode: dict[int, object] = {}        # tile -> mask
        decode_depth: dict[int, int] = {}        # tile -> decode depth
        for t in sorted(depth):
            key = (video, sot_id, epoch, t)
            arr = self.cache.get(key, depth[t], blocks=masks[t])
            if arr is not None:
                out[t] = arr
                continue
            nf, m = depth[t], masks[t]
            cov = self.cache.coverage(key)
            if cov is not None:
                # widen to cover the existing entry too, so the re-decode
                # can replace it (put never shrinks depth or coverage)
                nf = max(nf, cov[0])
                m = None if (m is None or cov[1] is None) else m | cov[1]
                if m is not None and len(m) == rec.layout.tile_blocks(t):
                    m = None
            to_decode[t] = m
            decode_depth[t] = nf
        fresh: set[int] = set()
        pixels_by_tile: dict[int, float] = {}
        if to_decode:
            # the whole merged group goes down in ONE decode_tiles call —
            # per-tile depths ride along, so the batched backend can fuse
            # every (tile, GOP, mask) selection into one dispatch
            blocks = {t: (None if m is None else tuple(sorted(m)))
                      for t, m in to_decode.items()}
            dec = entry.store.decode_tiles(sot_id, sorted(to_decode),
                                           n_frames=decode_depth,
                                           blocks=blocks)
            for t, arr in dec.items():
                out[t] = arr
                fresh.add(t)
                m = blocks[t]
                n_blocks = rec.layout.tile_blocks(t) if m is None else len(m)
                pixels_by_tile[t] = float(n_blocks * 64 * arr.shape[0])
                self.cache.put((video, sot_id, epoch, t), arr, blocks=m)
        return _GroupFetch(epoch=epoch, layout=rec.layout,
                           tiles=out, fresh=fresh, need=need,
                           pixels_by_tile=pixels_by_tile,
                           seconds=time.perf_counter() - t0)

    # ----------------------------------------------------------- per plan
    def _finish_one(self, idx: int, pplan: PhysicalPlan,
                    groups: dict[GroupKey, list[tuple[int, SOTScan]]],
                    fetched: dict[GroupKey, _GroupFetch],
                    batch_decode_s: float, single_plan: bool) -> ScanResult:
        engine = self.engine
        plan = pplan.logical
        stats = ScanStats(lookup_s=pplan.lookup_s)
        for ss in pplan.sot_scans:
            # tiles_decoded stays the planned estimate; pixels_decoded is
            # *actual* work for decoding scans (accumulated per fresh tile
            # below) and falls back to the estimate for .decode(False)
            if not plan.decode:
                stats.pixels_decoded += ss.est_pixels
            stats.tiles_decoded += ss.est_tiles

        regions_by_video: dict[str, list] = {v: [] for v in plan.videos}
        if plan.decode and pplan.sot_scans:
            if single_plan:
                # old executor semantics: wall time of the decode phase
                stats.decode_s = batch_decode_s
            for ss in pplan.sot_scans:
                gkey = (ss.video, ss.sot_id)
                rec = engine.video(ss.video).store.sots[ss.sot_id]
                f = fetched.get(gkey)
                if f is None or f.epoch != rec.epoch:
                    # an earlier plan's policy hook re-tiled this SOT (or the
                    # group was never fetched): re-fetch at the new epoch for
                    # this plan and the batch's remaining consumers
                    rest = [s for j, s in groups.get(gkey, []) if j >= idx]
                    f = self._fetch(gkey, rest or [ss])
                    fetched[gkey] = f
                if not single_plan and not f.time_claimed:
                    # merged batch: a group's fetch seconds are charged to
                    # its first consumer (like fresh-tile misses), so
                    # summing decode_s over history counts shared work once
                    f.time_claimed = True
                    stats.decode_s += f.seconds
                my_tiles = f.need.get(id(ss))
                if my_tiles is None:
                    my_tiles, _ = _resolve_needs(ss, rec)
                for t in my_tiles:
                    if t in f.fresh and t not in f.claimed:
                        f.claimed.add(t)
                        stats.cache_misses += 1
                        stats.pixels_decoded += f.pixels_by_tile.get(t, 0.0)
                    else:
                        stats.cache_hits += 1
                out = regions_by_video[ss.video]
                for frame, boxes in sorted(ss.boxes_by_frame.items()):
                    rel = frame - rec.frame_start
                    for box in boxes:
                        out.append((frame, box,
                                    _crop(f.layout, f.tiles, rel, box)))

        # policy hooks, serially per SOT, dispatched through the tuner:
        # inline mode observes + retiles here (charged to this query's
        # retile_s; any retile invalidates this batch's fetch via the epoch
        # bump), background mode only emits observations to the tuner's
        # workload log (retile_s stays 0 — tuning work lands in TunerStats)
        stats.retile_s += engine.tuner.on_scan(pplan.sot_scans)

        regions: list = []
        if len(plan.videos) == 1:
            regions = regions_by_video[plan.videos[0]]
        else:
            for v in plan.videos:
                regions.extend((v, f2, box, px)
                               for f2, box, px in regions_by_video[v])
        stats.regions = len(regions)
        engine.history.append(stats)
        for v in plan.videos:
            engine.video(v).history.append(stats)
        return ScanResult(regions=regions, stats=stats, plan=pplan,
                          regions_by_video=regions_by_video)


# --------------------------------------------------------------- serving
_STOP = object()


class ServingSession:
    """Concurrent submission surface over a :class:`ScanScheduler`.

    A dispatcher thread drains the submission queue and micro-batches
    whatever is queued into one ``execute_many`` call, so scans submitted
    concurrently (or back-to-back) merge their overlapping SOT decodes::

        with store.serve() as session:
            futs = [session.submit(store.scan("cam0").labels("car"))
                    for _ in range(8)]
            results = [f.result() for f in futs]

    ``submit`` accepts a :class:`ScanQuery`, :class:`ScanPlan` or
    :class:`PhysicalPlan` and returns a :class:`concurrent.futures.Future`
    resolving to the :class:`ScanResult`.
    """

    def __init__(self, scheduler: ScanScheduler, *, max_batch: int = 64):
        self._scheduler = scheduler
        self._max_batch = max(1, int(max_batch))
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        # orders submit's check+enqueue against close's flag-set, so a
        # submission either lands ahead of the _STOP sentinel or raises
        self._state_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="tasm-serve",
                                        daemon=True)
        self._thread.start()

    def submit(self, plan) -> Future:
        fut: Future = Future()
        with self._state_lock:
            if self._closed:
                raise RuntimeError("serving session is closed")
            self._q.put((plan, fut))
        return fut

    def execute(self, plan) -> ScanResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(plan).result()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            batch = [item]
            stop = False
            while len(batch) < self._max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            # normalize per submission so one bad query can't fail the batch
            plans, live = [], []
            for plan, fut in batch:
                if not fut.set_running_or_notify_cancel():
                    continue  # caller cancelled while queued
                try:
                    plans.append(self._scheduler._normalize(plan))
                    live.append(fut)
                except BaseException as e:
                    fut.set_exception(e)
            if plans:
                try:
                    results = self._scheduler.execute_many(plans)
                except BaseException as e:
                    for fut in live:
                        fut.set_exception(e)
                else:
                    for fut, res in zip(live, results):
                        fut.set_result(res)
            if stop:
                return

    def close(self) -> None:
        """Drain pending submissions, then stop the dispatcher."""
        with self._state_lock:
            if not self._closed:
                self._closed = True
                self._q.put(_STOP)
        self._thread.join()
        while True:  # fail anything that raced the close
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP and item[1].set_running_or_notify_cancel():
                item[1].set_exception(
                    RuntimeError("serving session is closed"))

    def __enter__(self) -> "ServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ crop
def _crop(layout: TileLayout, tiles: dict[int, np.ndarray],
          rel_frame: int, box: BBox) -> np.ndarray:
    """Assemble the pixels of ``box`` from decoded tiles of one frame
    (bit-identical to the engine's old serial path)."""
    y1, x1, y2, x2 = box
    out = np.zeros((y2 - y1, x2 - x1), dtype=np.float32)
    for t in layout.tiles_intersecting(box):
        if t not in tiles:
            continue
        ty1, tx1, ty2, tx2 = layout.tile_rect(t)
        iy1, ix1 = max(y1, ty1), max(x1, tx1)
        iy2, ix2 = min(y2, ty2), min(x2, tx2)
        if iy1 >= iy2 or ix1 >= ix2:
            continue
        out[iy1 - y1:iy2 - y1, ix1 - x1:ix2 - x1] = \
            tiles[t][rel_frame, iy1 - ty1:iy2 - ty1, ix1 - tx1:ix2 - tx1]
    return out
