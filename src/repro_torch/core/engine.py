"""VideoStore: the multi-video storage engine with a concurrent serving
layer (paper §3, Fig. 2, scaled up).

:class:`VideoStore` is a *catalog*: many named videos, each with its own
physical configuration (:class:`EncoderConfig`, tiling :class:`Policy`,
calibrated :class:`CostModel`, :class:`TileStore`, :class:`SemanticIndex`),
behind one declarative query surface::

    store = VideoStore(store_root="/data/tasm")
    store.add_video("cam0", encoder=EncoderConfig(gop=16), policy=RegretPolicy())
    store.ingest("cam0", frames)
    store.add_detections("cam0", dets_by_frame)
    res  = store.scan("cam0").labels("car").frames(0, 96).execute()
    plan = store.scan(["cam0", "cam1"]).labels("car").explain()  # no decode

Plan/execute split: the builder produces a logical :class:`ScanPlan`;
:meth:`VideoStore.lower` turns it into a :class:`PhysicalPlan` (the exact
SOTs and tile indices to decode, costed through the §4.1 what-if
interface).  Execution then goes through the **serving layer**:

- **Tile cache** (``core/tile_cache.py``) — a byte-budgeted, workload-
  predictive cache of decoded tile arrays keyed ``(video, sot_id, epoch,
  tile_idx)``.  Every tile fetch consults it before decoding, so
  overlapping scans stop re-decoding shared tiles; the epoch in the key
  means a ``retile`` invalidates naturally and the cache can never serve
  pre-retile pixels.  Configure it with ``VideoStore(cache=CacheConfig(
  budget_bytes=..., eviction=..., prefetch=..., block_packed=...))``
  (``budget_bytes=0`` disables); under ``prefetch`` the tuner's workload
  tap detects sliding-window scans and decodes the next SOTs ahead of the
  client (:meth:`drain_prefetch` is the deterministic barrier).
- **Scan scheduler** (``core/scheduler.py``) — :meth:`execute` is a thin
  client of a :class:`ScanScheduler` that accepts physical plans from
  concurrent callers, merges SOTScans targeting the same ``(video, sot_id,
  epoch)`` into one decode with the union of tile indices on a shared
  worker pool, and fans per-query results back out.  Batch submission:
  :meth:`execute_many`; concurrent submission: ``with store.serve() as s:
  s.submit(query)``.  Region assembly and policy hooks stay deterministic
  and bit-identical per query (plans finish strictly in submission order;
  a mid-batch retile triggers a re-fetch at the new epoch).
- **Physical tuner** (``core/tuner.py``) — policy-driven re-tiling runs in
  a background subsystem instead of inside the scan that triggered it.
  Under ``TuningConfig(mode="background")`` (the default) the scheduler's
  policy hooks
  only *emit observations* into a bounded workload log; a tuner thread
  replays them through the policies, coalesces proposals per SOT (newest
  wins), scores them through the §4.1 what-if interface, and applies
  winners via the durable, lock-taking, epoch-bumping retile path —
  queries are never charged re-encode time (``ScanStats.retile_s`` stays 0;
  see :meth:`tuner_stats`).  ``mode="inline"`` preserves the synchronous
  semantics bit-for-bit; ``mode="off"`` disables query-driven tuning.
  :meth:`drain_tuner` is the deterministic barrier for tests/benchmarks.

Knob surface: the serving knobs group into three config objects —
``VideoStore(cache=CacheConfig(...), tuning=TuningConfig(...),
decode=DecodeConfig(...))`` (see ``core/config.py`` for every field and
the explicit > deprecated-alias > environment > default precedence).  The
pre-config kwargs (``tile_cache_bytes``, ``tuning=<str>``,
``tuner_admission``, ``roi_decode``, ``decode_backend``) keep working for
one release as 1:1 aliases that emit ``DeprecationWarning``.

Persistence: with ``store_root`` set, durable state is sharded per video —
a small catalog file (``<root>/catalog.json``: version + video names) plus
one manifest per video (``<root>/<video>/manifest.json`` holding its
encoder, policy spec *and runtime state*, cost model, SOT records and
semantic-index entries).  A durable mutation to one video re-serializes
only that video's shard, not the whole catalog.  The v1 monolithic
``<root>/manifest.json`` is migrated on open (shards are written, the old
file is kept as ``*.v1.bak``), and v2 shards (no policy runtime state) are
adopted and rewritten as v3; every format reopens and serves scans without
re-ingesting.  Since v3, policy runtime state (accumulated regret, seen
labels) persists per shard, so a reopened store resumes tuning where it
left off instead of cold.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import time
import warnings
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core.config import CacheConfig, DecodeConfig, TuningConfig
from repro_torch.core.cost import CostModel, pixels_and_tiles, roi_pixels_and_tiles
from repro_torch.core.layout import TileLayout
from repro_torch.core.policies import (NoTilingPolicy, Policy, policy_from_spec,
                                 policy_spec)
from repro_torch.core.query import (PhysicalPlan, ScanPlan, ScanQuery, ScanResult,
                              ScanStats, SOTScan)
from repro_torch.core.scheduler import ScanScheduler, ServingSession
from repro_torch.core.semantic_index import SemanticIndex
from repro_torch.core.storage import SOTRecord, TileStore, tile_checksum
from repro_torch.core.tile_cache import CacheStats, TileCache
from repro_torch.core.tuner import PhysicalTuner, TunerStats

#: valid what-if cost granularities: "tile" = standard full-tile decoder
#: (the basis for layout decisions), "block" = actual ROI-restricted decode
GRANULARITIES = ("tile", "block")

CATALOG_NAME = "catalog.json"      # v2+: version + video names, O(#videos)
MANIFEST_NAME = "manifest.json"    # v2+: per-video shard; v1: the monolith
IMPORT_DIR_NAME = ".import"        # staging namespace for replica copies
MANIFEST_VERSION = 3               # v3: + per-video policy runtime state
COMPAT_SHARD_VERSIONS = (2, MANIFEST_VERSION)   # v2 adopted, rewritten as v3
LEGACY_MANIFEST_VERSION = 1


@dataclass
class IngestStats:
    """Unified ingest accounting (one contract for every ingest path).

    - ``encode_s``  — seconds encoding the incoming frames (always paid).
    - ``pretile_s`` — *extra* seconds re-tiling beyond the plain encode
      (policy-driven pre-tiling).  0.0 when layouts arrive with the video
      (edge tiling: the camera already paid for them) or nothing pre-tiles.
    """
    encode_s: float = 0.0
    pretile_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.encode_s + self.pretile_s


@dataclass
class VideoEntry:
    """One catalog entry: a video plus its physical configuration."""
    name: str
    encoder: EncoderConfig
    policy: Policy
    cost_model: CostModel
    store: TileStore
    index: SemanticIndex
    frame_hw: Optional[tuple[int, int]] = None
    history: list = field(default_factory=list)


def _deprecated_kwarg(name: str, replacement: str) -> None:
    warnings.warn(
        f"VideoStore({name}=...) is deprecated and will be removed next "
        f"release; use {replacement}", DeprecationWarning, stacklevel=4)


def _resolve_configs(cache, tuning, decode, *, tile_cache_bytes,
                     tuner_admission, roi_decode, decode_backend,
                     max_decode_workers):
    """Fold the deprecated per-knob kwargs into the three config objects
    and resolve them (env overrides + defaults; see ``core/config.py``).
    Each alias maps 1:1 onto one config field; passing an alias together
    with the config object it folds into is an error, never a silent
    pick.  ``max_decode_workers`` predates the sprawl and stays accepted
    without a warning (it equals ``DecodeConfig(max_workers=...)``)."""
    if tile_cache_bytes is not None:
        if cache is not None:
            raise ValueError("pass cache=CacheConfig(...) or "
                             "tile_cache_bytes=..., not both")
        _deprecated_kwarg("tile_cache_bytes",
                          "cache=CacheConfig(budget_bytes=...)")
        cache = CacheConfig(budget_bytes=tile_cache_bytes)
    cache = (cache if cache is not None else CacheConfig()).resolve()

    if isinstance(tuning, str):
        _deprecated_kwarg("tuning=<mode string>",
                          "tuning=TuningConfig(mode=...)")
        tuning = TuningConfig(mode=tuning,
                              admission=tuner_admission or "policy")
        if tuner_admission is not None:
            _deprecated_kwarg("tuner_admission",
                              "tuning=TuningConfig(admission=...)")
    elif tuner_admission is not None:
        if tuning is not None:
            raise ValueError("pass tuning=TuningConfig(...) or "
                             "tuner_admission=..., not both")
        _deprecated_kwarg("tuner_admission",
                          "tuning=TuningConfig(admission=...)")
        tuning = TuningConfig(admission=tuner_admission)
    tuning = (tuning if tuning is not None else TuningConfig()).resolve()

    legacy = {}
    if roi_decode is not None:
        _deprecated_kwarg("roi_decode", "decode=DecodeConfig(roi=...)")
        legacy["roi"] = roi_decode
    if decode_backend is not None:
        _deprecated_kwarg("decode_backend",
                          "decode=DecodeConfig(backend=...)")
        legacy["backend"] = decode_backend
    if max_decode_workers is not None:
        legacy["max_workers"] = max_decode_workers
    if legacy:
        if decode is not None:
            raise ValueError(
                f"pass decode=DecodeConfig(...) or the per-knob kwargs "
                f"({', '.join(sorted(legacy))}), not both")
        decode = DecodeConfig(**legacy)
    decode = (decode if decode is not None else DecodeConfig()).resolve()
    return cache, tuning, decode


class VideoStore:
    """Catalog of videos + declarative scan queries served through a
    cached, merging scheduler."""

    def __init__(self, store_root: Optional[str] = None, *,
                 default_encoder: Optional[EncoderConfig] = None,
                 default_policy: Optional[Policy] = None,
                 default_cost_model: Optional[CostModel] = None,
                 cache: Optional[CacheConfig] = None,
                 tuning: "Optional[TuningConfig | str]" = None,
                 decode: Optional[DecodeConfig] = None,
                 autoload: bool = True,
                 # deprecated keyword aliases (one release; each maps 1:1
                 # onto a config field — see _resolve_configs)
                 max_decode_workers: Optional[int] = None,
                 tile_cache_bytes: Optional[int] = None,
                 tuner_admission: Optional[str] = None,
                 roi_decode: Optional[bool] = None,
                 decode_backend: Optional[str] = None):
        cache_cfg, tuning_cfg, decode_cfg = _resolve_configs(
            cache, tuning, decode,
            tile_cache_bytes=tile_cache_bytes,
            tuner_admission=tuner_admission, roi_decode=roi_decode,
            decode_backend=decode_backend,
            max_decode_workers=max_decode_workers)
        #: resolved config objects (every knob concrete; see core/config.py
        #: for the explicit > alias > env > default precedence)
        self.cache_config = cache_cfg
        self.tuning_config = tuning_cfg
        self.decode_config = decode_cfg
        self.root = pathlib.Path(store_root) if store_root else None
        self.default_encoder = default_encoder or EncoderConfig()
        self.default_policy = default_policy
        self.default_cost_model = default_cost_model
        self.max_decode_workers = decode_cfg.max_workers
        self._videos: dict[str, VideoEntry] = {}
        # replica-import staging for in-memory stores (on-disk stores stage
        # under <root>/.import/<video>/ so a killed destination can resume)
        self._import_mem: dict[str, dict[tuple, tuple]] = {}
        self.history: list[ScanStats] = []
        self._dirty_videos: set[str] = set()
        # videos whose policy runtime state mutated without dirtying the
        # shard (inline observes with no proposal); flushed by close()
        self._stale_policy_state: set[str] = set()
        self._catalog_dirty = False
        self.tile_cache = TileCache(config=cache_cfg)
        self.scheduler = ScanScheduler(self, cache=self.tile_cache)
        # ROI-restricted decode: lowering threads per-tile 8x8-block masks
        # into the plan, so subframe scans decode only the blocks their
        # boxes intersect.  False restores full-tile decode (results
        # are bit-identical either way; the flag may be flipped at runtime
        # and only affects plans lowered afterwards)
        self.roi_decode = decode_cfg.roi
        # decode backend="numpy"|"batched": how TileStore.decode_tiles runs —
        # the per-tile numpy oracle loop, or fused CUDA-kernel dispatches
        # over the whole merged batch on decode_config.device (see
        # codec/batch.py).
        self.decode_backend = decode_cfg.backend
        # tuning mode="background"|"inline"|"off": where policy-driven
        # retiling runs (async tuner thread / inside the scan / nowhere);
        # admission="policy"|"gated": whether the background tuner
        # additionally gates + ranks proposals by their what-if net benefit
        self.tuner = PhysicalTuner(self, mode=tuning_cfg.mode,
                                   admission=tuning_cfg.admission,
                                   max_log=tuning_cfg.max_log)
        if self.root is not None and autoload:
            if self.catalog_path.exists():
                self._load_catalog()
            elif self.legacy_manifest_path.exists():
                self._migrate_v1()

    # ------------------------------------------------------------- catalog
    @property
    def catalog_path(self) -> pathlib.Path:
        assert self.root is not None
        return self.root / CATALOG_NAME

    @property
    def legacy_manifest_path(self) -> pathlib.Path:
        """The v1 monolithic manifest (pre-sharding)."""
        assert self.root is not None
        return self.root / MANIFEST_NAME

    def video_manifest_path(self, name: str) -> pathlib.Path:
        assert self.root is not None
        return self.root / name / MANIFEST_NAME

    def videos(self) -> list[str]:
        return sorted(self._videos)

    def video(self, name: str) -> VideoEntry:
        try:
            return self._videos[name]
        except KeyError:
            raise KeyError(f"unknown video {name!r}; catalog has "
                           f"{self.videos()}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._videos

    def __len__(self) -> int:
        return len(self._videos)

    def __iter__(self) -> Iterator[str]:
        return iter(self.videos())

    def add_video(self, name: str, *,
                  encoder: Optional[EncoderConfig] = None,
                  policy: Optional[Policy] = None,
                  cost_model: Optional[CostModel] = None,
                  sot_len: Optional[int] = None) -> VideoEntry:
        if name in self._videos:
            raise ValueError(f"video {name!r} already in catalog")
        enc = encoder or self.default_encoder
        if policy is None:
            # clone the default so stateful policies (regret accumulators)
            # never share state across videos
            policy = (policy_from_spec(self.default_policy.spec())
                      if self.default_policy else NoTilingPolicy())
        entry = VideoEntry(
            name=name, encoder=enc, policy=policy,
            cost_model=cost_model or self.default_cost_model or CostModel(),
            store=TileStore(name, enc,
                            root=str(self.root) if self.root else None,
                            sot_len=sot_len,
                            decode_backend=self.decode_backend,
                            device=self.decode_config.device),
            index=SemanticIndex())
        self._videos[name] = entry
        self._catalog_dirty = True
        self._dirty_videos.add(name)
        return entry

    def drop_video(self, name: str) -> None:
        with self.scheduler.lock:
            entry = self.video(name)
            del self._videos[name]
            self._dirty_videos.discard(name)
            self._stale_policy_state.discard(name)
            self.tile_cache.invalidate(video=name)
            if self.root is not None:
                # catalog first: a crash after it lands leaves only an
                # orphaned shard directory (harmless), never a catalog
                # pointing at a missing shard (unopenable store)
                self._catalog_dirty = True
                self.save()
                d = self.root / entry.name
                if d.exists():
                    shutil.rmtree(d)   # tiles + the video's manifest shard

    # ---------------------------------------------------------- dirtiness
    def _mark_dirty(self, *names: str) -> None:
        self._dirty_videos.update(names)

    @property
    def dirty(self) -> bool:
        return bool(self._dirty_videos or self._catalog_dirty)

    # -------------------------------------------------------------- ingest
    def ingest(self, name: str, frames: np.ndarray, *, detections=None,
               initial_layouts: Optional[dict[int, TileLayout]] = None,
               **video_kw) -> IngestStats:
        """Encode ``frames`` into video ``name`` (auto-registered if absent).

        ``detections``: per-frame ``[(label, bbox)]`` preloading the semantic
        index before the policy's ``on_ingest`` runs (eager/edge strategies).
        ``initial_layouts``: sot_id -> layout applied at encode time (the
        edge-tiling path); when given, the policy's ``on_ingest`` is skipped.
        Returns :class:`IngestStats` — see its docstring for the contract.
        """
        with self.scheduler.lock:   # no scan observes a half-ingested video
            entry = self._videos.get(name)
            if entry is None:
                entry = self.add_video(name, **video_kw)
            elif video_kw:
                raise ValueError(
                    f"video {name!r} already configured; per-video kwargs "
                    f"{sorted(video_kw)} only apply on first ingest")
            if entry.store.sots:
                # appending footage needs sot_id offsetting the store does
                # not do; a second ingest would collide sot_ids 0..n-1 with
                # the existing records and duplicate every scan's regions
                raise ValueError(
                    f"video {name!r} already has ingested frames; "
                    "re-ingest/append is not supported")
            entry.frame_hw = frames.shape[1:]
            if detections is not None:
                for f, dets in enumerate(detections):
                    for label, bbox in dets:
                        entry.index.add(name, f, label, bbox)
            stats = IngestStats()
            if initial_layouts:
                stats.encode_s = entry.store.ingest(
                    frames, layouts=dict(initial_layouts))
            else:
                # encode untiled first so the store has SOT records for the
                # policy
                stats.encode_s = entry.store.ingest(frames, layouts=None)
                pre = entry.policy.on_ingest(entry.index, entry.store, name,
                                             entry.frame_hw)
                for sot_id, layout in (pre or {}).items():
                    stats.pretile_s += entry.store.retile(sot_id, layout)
            self._mark_dirty(name)
            self.save()
        return stats

    # ------------------------------------------------------------ metadata
    def add_metadata(self, video: str, frame: int, label: str,
                     x1: int, y1: int, x2: int, y2: int) -> None:
        """The paper's ADDMETADATA(v, f, label, x1, y1, x2, y2); durable —
        the mutation is persisted before returning."""
        with self.scheduler.lock:
            self.video(video).index.add_metadata(video, frame, label,
                                                 x1, y1, x2, y2)
            self._mark_dirty(video)
            self.save()

    def add_detections(self, video: str, detections_by_frame: dict) -> None:
        with self.scheduler.lock:
            entry = self.video(video)
            for f, dets in detections_by_frame.items():
                for label, bbox in dets:
                    entry.index.add(video, f, label, bbox)
            self._mark_dirty(video)
            self.save()

    # ---------------------------------------------------------------- scan
    def scan(self, videos, labels=None,
             frames: Optional[tuple[int, int]] = None) -> ScanQuery:
        """Start a scan-query builder over one video or a list of videos.

        ``labels``/``frames`` are optional shortcuts for the corresponding
        builder calls: ``store.scan("cam0", "car", (0, 96))``.
        """
        q = ScanQuery(self, videos)
        if labels is not None:
            q = q.labels(labels)
        if frames is not None:
            q = q.frames(*frames)
        return q

    # ---------------------------------------------------------- plan/lower
    def lower(self, plan: ScanPlan) -> PhysicalPlan:
        """Lower a logical plan to the exact SOTs + tile indices to decode,
        costing each SOT through the what-if interface.  Pure: touches only
        the semantic index, never tile data.  Takes the scheduler lock so a
        concurrent ingest/add_detections can't mutate the B+-trees under a
        running index scan."""
        with self.scheduler.lock:
            return self._lower(plan)

    def _sot_cost_walk(self, entry: VideoEntry, boxes_by_frame: dict,
                       layout_by_sot: Optional[dict[int, TileLayout]] = None,
                       granularity: str = "tile"):
        """The shared SOT-walking cost loop of the §4.1 what-if interface:
        for each SOT overlapping the boxed frames, restrict the boxes to
        the SOT and cost them under its layout (or a hypothetical override
        from ``layout_by_sot``).  Yields ``(rec, epoch, layout, local,
        est_pixels, est_tiles, est_cost_s, blocks_by_tile)``.  Callers:
        :meth:`_lower` (physical planning), :meth:`what_if` (hypothetical
        layouts), and the :class:`~repro_torch.core.tuner.PhysicalTuner`
        (proposal scoring).  Caller must hold the scheduler lock.

        ``granularity``: ``"tile"`` charges a standard full-tile decoder
        (``pixels_and_tiles``; ``blocks_by_tile`` is None) — the basis for
        layout decisions, since block-granular pixels are layout-invariant;
        ``"block"`` charges the engine's actual ROI-restricted decode and
        yields the per-tile block-coverage masks the plan carries."""
        if granularity not in GRANULARITIES:
            raise ValueError(f"unknown cost granularity {granularity!r}; "
                             f"want one of {GRANULARITIES}")
        if not boxes_by_frame:
            return
        f_lo, f_hi = min(boxes_by_frame), max(boxes_by_frame) + 1
        for rec in entry.store.sots_in_range(f_lo, f_hi):
            span = (rec.frame_start, rec.frame_end)
            local = {f: b for f, b in boxes_by_frame.items()
                     if span[0] <= f < span[1]}
            if not local:
                continue
            # epoch BEFORE layout: engine-level retiles hold the scheduler
            # lock we're under, but store-level retile() calls bypass it —
            # if one interleaves (it installs the layout, then bumps the
            # epoch), reading the epoch first leaves the caller's SOTScan
            # detectably stale, and execution recomputes its tiles against
            # the layout of record
            epoch = rec.epoch
            layout = rec.layout
            if layout_by_sot is not None:
                layout = layout_by_sot.get(rec.sot_id, layout)
            bbt = None
            if granularity == "block":
                # io_pixels feeds the third cost-model term: tile opens
                # decompress the full coefficient stream even when the ROI
                # gathers few blocks (0-cost when io_per_pixel is
                # uncalibrated, so legacy stores estimate as before)
                p, t, iop, bbt = roi_pixels_and_tiles(
                    layout, local, gop=entry.encoder.gop, sot_frames=span)
                cost = entry.cost_model.cost(p, t, iop)
            else:
                p, t = pixels_and_tiles(layout, local, gop=entry.encoder.gop,
                                        sot_frames=span)
                cost = entry.cost_model.cost(p, t)
            yield (rec, epoch, layout, local, p, t, cost, bbt)

    def _lower(self, plan: ScanPlan) -> PhysicalPlan:
        pplan = PhysicalPlan(logical=plan)
        remaining = plan.limit
        for name in plan.videos:
            entry = self.video(name)
            if plan.cnf == ():   # all-labels sentinel from .labels()
                all_labels = tuple(sorted(entry.index.labels(name)))
                if not all_labels:
                    continue
                cnf = (all_labels,)
            else:
                cnf = plan.cnf
            flat_labels = tuple(sorted({l for clause in cnf for l in clause}))
            t0 = time.perf_counter()
            boxes_by_frame = entry.index.query(name, cnf, plan.frame_range)
            pplan.lookup_s += time.perf_counter() - t0
            if remaining is not None:
                boxes_by_frame = _apply_limit(boxes_by_frame, remaining)
                remaining -= sum(len(b) for b in boxes_by_frame.values())
            if not boxes_by_frame:
                continue
            qrange = plan.frame_range or (min(boxes_by_frame),
                                          max(boxes_by_frame) + 1)
            gran = "block" if self.roi_decode else "tile"
            for rec, epoch, layout, local, p, t, cost, bbt in \
                    self._sot_cost_walk(entry, boxes_by_frame,
                                        granularity=gran):
                if bbt is not None:
                    needed = set(bbt)
                else:
                    needed = set()
                    for f, boxes in local.items():
                        for box in boxes:
                            needed.update(layout.tiles_intersecting(box))
                pplan.sot_scans.append(SOTScan(
                    video=name, sot_id=rec.sot_id, epoch=epoch,
                    tile_idxs=tuple(sorted(needed)),
                    n_frames=max(local) - rec.frame_start + 1,
                    boxes_by_frame=local, query_range=qrange,
                    labels=flat_labels, est_pixels=p, est_tiles=t,
                    est_cost_s=cost, blocks_by_tile=bbt or {}))
        return pplan

    # -------------------------------------------------------------- execute
    def execute(self, pplan: PhysicalPlan) -> ScanResult:
        """Run a physical plan through the serving layer (cached, merged
        decodes on the shared worker pool; deterministic region assembly;
        per-SOT policy hooks)."""
        return self.scheduler.execute(pplan)

    def execute_many(self, plans) -> list[ScanResult]:
        """Execute several scans as one batch: SOTScans targeting the same
        ``(video, sot_id, epoch)`` are merged into one decode (union of tile
        indices), so each shared tile is decoded at most once.  Accepts
        :class:`ScanQuery`, :class:`ScanPlan` or :class:`PhysicalPlan`
        items; results come back in submission order, each bit-identical to
        a serial :meth:`execute` of the same plan."""
        return self.scheduler.execute_many(plans)

    def serve(self, **kw) -> ServingSession:
        """Open a concurrent serving session (micro-batching dispatcher)::

            with store.serve() as session:
                futs = [session.submit(q) for q in queries]
                results = [f.result() for f in futs]
        """
        return self.scheduler.session(**kw)

    def drain_tuner(self, timeout: Optional[float] = None) -> TunerStats:
        """Deterministic tuning barrier: block until every observation
        emitted before this call has been replayed through the policies,
        every surviving proposal applied, and the resulting state
        persisted.  No-op under ``tuning="inline"``/``"off"``.  Returns a
        :class:`TunerStats` snapshot."""
        self.tuner.drain(timeout)
        return self.tuner.stats()

    def tuner_stats(self) -> TunerStats:
        """Snapshot of the physical tuner's cumulative accounting
        (observations, coalesced/applied/skipped retiles, tuning and
        re-encode seconds)."""
        return self.tuner.stats()

    def drain_prefetch(self, timeout: Optional[float] = None) -> CacheStats:
        """Deterministic prefetch barrier: block until every predictive
        decode enqueued before this call has completed (no-op unless
        ``CacheConfig.prefetch``).  Returns a :class:`CacheStats`
        snapshot, so callers can assert on ``prefetch_issued`` etc."""
        self.scheduler.drain_prefetch(timeout)
        return self.tile_cache.stats()

    def config(self) -> dict:
        """The resolved runtime configuration as wire-ready documents
        (``{"cache": ..., "tuning": ..., "decode": ...}``) — the same
        surface ``RemoteVideoStore.config()`` and the router expose.
        ``decode.roi`` reflects the live ``roi_decode`` flag (it may be
        flipped at runtime)."""
        return {"cache": self.cache_config.to_doc(),
                "tuning": self.tuning_config.to_doc(),
                "decode": {**self.decode_config.to_doc(),
                           "roi": bool(self.roi_decode)}}

    def close(self) -> None:
        """Stop the tuner thread (flushing its workload log), flush dirty
        durable state, and release the decode worker pool.  The store
        remains usable; a later scan re-creates both on demand."""
        # outside the scheduler lock: the tuner's flush needs to take it
        self.tuner.stop()
        with self.scheduler.lock:
            # inline observes mutate stateful-policy runtime state without
            # dirtying the shard (no full rewrite per query); flush the
            # noted remainder so a reopened store resumes exactly
            self._mark_dirty(*(self._stale_policy_state & set(self._videos)))
            if self.dirty:
                self.save()
        self.scheduler.shutdown()

    def __enter__(self) -> "VideoStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- retile
    def retile(self, video: str, sot_id: int, new_layout: TileLayout
               ) -> float:
        """Durably re-tile one SOT through the serving layer: takes the
        scheduler's lock (no scan observes a half-retiled SOT), bumps the
        epoch, purges stale cache entries, persists the video's shard.
        Returns re-encode seconds (0.0 if the layout is unchanged)."""
        with self.scheduler.lock:
            dt = self._retile(video, sot_id, new_layout)
            if self.dirty:
                self.save()
        return dt

    def _retile(self, video: str, sot_id: int, new_layout: TileLayout
                ) -> float:
        """Retile without persisting (scheduler policy-hook path; the batch
        saves once at the end).  Caller must hold ``scheduler.lock``."""
        entry = self.video(video)
        dt = entry.store.retile(sot_id, new_layout)
        if dt:
            rec = entry.store.sots[sot_id]
            self.tile_cache.invalidate(video, sot_id,
                                       before_epoch=rec.epoch)
            self._mark_dirty(video)
        return dt

    # -------------------------------------------------------------- what-if
    def what_if(self, video: str, labels,
                layout_by_sot: dict[int, TileLayout],
                t_range: Optional[tuple[int, int]] = None,
                granularity: str = "tile") -> float:
        """§4.1 what-if interface: estimated cost of a query under alternate
        layouts, without touching tile data.  Locked like :meth:`lower`, so
        concurrent durable mutations can't shift the B+-trees mid-scan.

        ``granularity="tile"`` (default) models a standard full-tile
        decoder — the cost that *layout decisions* compare, used by the
        policies' alpha/regret gates and the tuner's proposal scoring.
        ``granularity="block"`` models the engine's ROI-restricted decode
        (what a scan actually pays; matches ``explain().est_cost_s`` when
        ``roi_decode`` is on).  Block-granular pixel cost is
        layout-invariant — tile boundaries are 8-aligned — which is exactly
        why it cannot replace the tile-granular cost for choosing layouts."""
        with self.scheduler.lock:
            entry = self.video(video)
            boxes_by_frame = entry.index.query(video, labels, t_range)
            return sum(cost for *_, cost, _bbt in self._sot_cost_walk(
                entry, boxes_by_frame, layout_by_sot=layout_by_sot,
                granularity=granularity))

    def epochs(self, video: str) -> dict[int, int]:
        """``{sot_id: layout epoch}`` snapshot for one video.  A retile
        bumps the SOT's epoch, so two stores holding the same video serve
        the same physical layout generation iff these tables match — the
        check the cluster router runs before reading from a replica."""
        with self.scheduler.lock:
            return {r.sot_id: r.epoch
                    for r in self.video(video).store.sots}

    # ------------------------------------------------------ repair copy path
    # Node->node replica streaming (the cluster's repair/rebalance data
    # plane).  The source side is read-only (`export_entry` snapshots the
    # manifest doc, `export_tile` one encoded tile stream at its current
    # epoch); the destination stages chunks under a temp namespace keyed by
    # video, verifies each chunk's sha256 on arrival AND again at commit,
    # and only `commit_import` makes the video visible — the catalog write
    # is the commit point, so a SIGKILL anywhere mid-copy leaves zero torn
    # state (stray staging files are re-verified or discarded on resume).

    def export_entry(self, name: str) -> dict:
        """The video's manifest-shard doc (encoder, policy + runtime state,
        cost model, semantic index, SOT/epoch table) — the metadata leg of
        a replica copy, fetched last so the epoch table it carries reflects
        every chunk already streamed."""
        with self.scheduler.lock:
            return {"version": MANIFEST_VERSION, "name": name,
                    **self._entry_doc(self.video(name))}

    def export_tile(self, name: str, sot_id: int, tile_idx: int) -> dict:
        """One encoded tile stream at its current epoch, with a content
        checksum.  Reads run off-lock so exports never stall serving; a
        foreground retile racing the read is detected by an epoch re-check
        and the read retries against the new generation."""
        for _ in range(8):
            with self.scheduler.lock:
                entry = self.video(name)
                if not 0 <= sot_id < len(entry.store.sots):
                    raise ValueError(f"video {name!r} has no SOT {sot_id}")
                rec = entry.store.sots[sot_id]
                if not 0 <= tile_idx < rec.layout.n_tiles:
                    raise ValueError(
                        f"SOT {sot_id} of {name!r} has no tile {tile_idx} "
                        f"(layout {rec.layout.describe()})")
                epoch = rec.epoch
            try:
                enc = entry.store._read_tile(rec, tile_idx)
            except (KeyError, FileNotFoundError):
                continue    # retile raced the read: retry at the new epoch
            with self.scheduler.lock:
                if rec.epoch != epoch:
                    continue
            return {"sot_id": sot_id, "epoch": epoch, "tile_idx": tile_idx,
                    "enc": {"kq": list(enc["kq"]), "pq": list(enc["pq"]),
                            "h": enc["h"], "w": enc["w"], "gop": enc["gop"],
                            "qp": enc["qp"], "n_frames": enc["n_frames"],
                            "size_bytes": float(enc["size_bytes"])},
                    "checksum": tile_checksum(enc)}
        raise RuntimeError(f"export of {name!r} SOT {sot_id} kept racing "
                           f"retiles; giving up after 8 attempts")

    def _import_dir(self, name: str) -> pathlib.Path:
        assert self.root is not None
        return self.root / IMPORT_DIR_NAME / name

    def begin_import(self, name: str) -> dict:
        """Open — or resume — the staging namespace for an incoming replica
        copy.  Returns every chunk already staged and intact
        (``{"staged": [[sot_id, epoch, tile_idx, checksum], ...]}``) so a
        retried repair re-streams only what is missing; torn leftovers from
        a killed destination are verified against their stored checksum and
        discarded."""
        with self.scheduler.lock:
            if name in self._videos:
                raise ValueError(
                    f"video {name!r} already exists on this node")
            staged = []
            if self.root is None:
                for (s, e, t), (_enc, sha) in sorted(
                        self._import_mem.get(name, {}).items()):
                    staged.append([s, e, t, sha])
                return {"staged": staged}
            d = self._import_dir(name)
            d.mkdir(parents=True, exist_ok=True)
            for f in sorted(d.iterdir()):
                if f.name.startswith("."):  # tmp torn by a mid-write kill
                    f.unlink(missing_ok=True)
                    continue
                chunk = _load_staged_tile(f)
                if chunk is None:           # unreadable or checksum-torn
                    f.unlink(missing_ok=True)
                    continue
                s, e, t, _enc, sha = chunk
                staged.append([s, e, t, sha])
            return {"staged": staged}

    def stage_import_chunk(self, name: str, sot_id: int, epoch: int,
                           tile_idx: int, enc: dict, checksum: str) -> None:
        """Land one streamed tile chunk in the staging namespace.  The
        checksum is recomputed over the decoded payload — a chunk torn in
        flight is rejected here, before it can ever reach a commit."""
        enc = {"kq": list(enc["kq"]), "pq": list(enc["pq"]),
               "h": int(enc["h"]), "w": int(enc["w"]),
               "gop": int(enc["gop"]), "qp": int(enc["qp"]),
               "n_frames": int(enc["n_frames"]),
               "size_bytes": float(enc["size_bytes"])}
        got = tile_checksum(enc)
        if got != checksum:
            raise ValueError(
                f"checksum mismatch staging {name!r} SOT {sot_id} tile "
                f"{tile_idx} (epoch {epoch}): chunk arrived torn")
        with self.scheduler.lock:
            if name in self._videos:
                raise ValueError(
                    f"video {name!r} already exists on this node")
            if self.root is None:
                self._import_mem.setdefault(name, {})[
                    (int(sot_id), int(epoch), int(tile_idx))] = (enc, checksum)
                return
        d = self._import_dir(name)
        d.mkdir(parents=True, exist_ok=True)
        final = d / f"s{int(sot_id)}_e{int(epoch)}_t{int(tile_idx)}.npz"
        tmp = d / f".{final.name}.tmp"
        members = {}
        for g in range(len(enc["kq"])):
            members[f"kq_{g}"] = enc["kq"][g]
            members[f"pq_{g}"] = enc["pq"][g]
        with open(tmp, "wb") as fh:  # handle, not name: numpy would
            np.savez_compressed(     # append ".npz" to the tmp name
                fh,
                meta=np.array([enc["h"], enc["w"], enc["gop"], enc["qp"],
                               enc["n_frames"]]),
                size=np.array([enc["size_bytes"]]),
                key=np.array([sot_id, epoch, tile_idx], dtype=np.int64),
                sha=np.frombuffer(checksum.encode(),
                                  dtype=np.uint8).copy(),
                **members)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)

    def _staged_chunk(self, name: str, sot_id: int, epoch: int,
                      tile_idx: int):
        """The staged enc for one chunk, re-verified, or None."""
        if self.root is None:
            got = self._import_mem.get(name, {}).get(
                (sot_id, epoch, tile_idx))
            return got[0] if got else None
        f = self._import_dir(name) / f"s{sot_id}_e{epoch}_t{tile_idx}.npz"
        if not f.exists():
            return None
        chunk = _load_staged_tile(f)
        return chunk[3] if chunk else None

    def commit_import(self, name: str, doc: dict,
                      min_epochs: Optional[dict] = None) -> dict:
        """Flip a fully staged replica copy live, atomically.  Verifies the
        doc's epoch table against ``min_epochs`` (the router's expected
        generations — a pre-retile copy never commits), re-verifies every
        tile's checksum from staging, then installs the entry and persists
        shard + catalog; the catalog write is the commit point.  Idempotent:
        re-committing a video already present at >= epochs is a no-op."""
        with self.scheduler.lock:
            doc_epochs = {int(s["sot_id"]): int(s["epoch"])
                          for s in doc["sots"]}
            if name in self._videos:
                have = {r.sot_id: r.epoch
                        for r in self._videos[name].store.sots}
                if all(have.get(s, -1) >= e for s, e in doc_epochs.items()):
                    self._discard_import(name)
                    return {"ok": True, "already": True,
                            "epochs": sorted(have.items())}
                raise ValueError(
                    f"video {name!r} already exists at older epochs; "
                    f"drop it before re-importing")
            for s, e in (min_epochs or {}).items():
                if doc_epochs.get(int(s), -1) < int(e):
                    raise ValueError(
                        f"import of {name!r} is stale: SOT {s} staged at "
                        f"epoch {doc_epochs.get(int(s), -1)} < required {e}")
            tiles = {}
            for s in doc["sots"]:
                n_tiles = len(s["heights"]) * len(s["widths"])
                for t in range(n_tiles):
                    key = (int(s["sot_id"]), int(s["epoch"]), t)
                    enc = self._staged_chunk(name, *key)
                    if enc is None:
                        raise ValueError(
                            f"cannot commit {name!r}: SOT {key[0]} tile {t} "
                            f"(epoch {key[1]}) is not staged intact")
                    tiles[key] = enc
            entry = self._entry_from_doc(name, doc, tiles=tiles)
            self._videos[name] = entry
            self._catalog_dirty = True
            self._dirty_videos.add(name)
            self.save()
            self._discard_import(name)
            return {"ok": True, "already": False,
                    "epochs": sorted(doc_epochs.items())}

    def abort_import(self, name: str) -> None:
        """Drop the staging namespace for a cancelled copy."""
        with self.scheduler.lock:
            self._discard_import(name)

    def _discard_import(self, name: str) -> None:
        self._import_mem.pop(name, None)
        if self.root is not None:
            d = self._import_dir(name)
            if d.exists():
                shutil.rmtree(d, ignore_errors=True)

    # ---------------------------------------------------------------- stats
    def storage_bytes(self, video: Optional[str] = None) -> float:
        if video is not None:
            return self.video(video).store.storage_bytes()
        return float(sum(e.store.storage_bytes()
                         for e in self._videos.values()))

    def stats(self) -> dict:
        """JSON-able engine-wide accounting snapshot: catalog membership,
        per-video decode/storage counters, and tile-cache stats.  This is
        the ``stats`` RPC of the socket front end (``core/server.py``), and
        what benchmarks use to assert cross-client cache sharing (a warm
        repeat leaves ``tiles_decoded_total`` unchanged)."""
        with self.scheduler.lock:
            per_video = {
                name: {"n_sots": len(e.store.sots),
                       "labels": sorted(e.index.labels(name)),
                       "tiles_decoded_total": e.store.tiles_decoded_total,
                       "pixels_decoded_total": e.store.pixels_decoded_total,
                       "storage_bytes": e.store.storage_bytes(),
                       "queries": len(e.history)}
                for name, e in self._videos.items()}
            # reply-marshalling accounting: per-query ScanStats objects in
            # history are stamped IN PLACE by the serving layer after the
            # reply ships, so served queries show up here with their
            # transport and packing cost (in-process queries contribute 0)
            by_transport: dict[str, int] = {}
            marshal_s = payload_bytes = 0.0
            for s in self.history:
                marshal_s += s.marshal_s
                payload_bytes += s.payload_bytes
                if s.transport:
                    by_transport[s.transport] = \
                        by_transport.get(s.transport, 0) + 1
            return {"videos": self.videos(),
                    "queries": len(self.history),
                    "storage_bytes": self.storage_bytes(),
                    "tiles_decoded_total": sum(
                        v["tiles_decoded_total"] for v in per_video.values()),
                    "pixels_decoded_total": sum(
                        v["pixels_decoded_total"]
                        for v in per_video.values()),
                    "per_video": per_video,
                    "marshalling": {"marshal_s": marshal_s,
                                    "payload_bytes": payload_bytes,
                                    "by_transport": by_transport},
                    "cache": dataclasses.asdict(self.tile_cache.stats())}

    # ------------------------------------------------------------- manifest
    def save(self, *, full: bool = False) -> None:
        """Persist durable state when backed by disk: the shards of dirty
        videos plus, when membership changed, the catalog file.  Each write
        is atomic (tmp + rename); ``full=True`` rewrites everything.
        Takes the scheduler lock, so saves never race a batch's end-of-run
        save or a concurrent durable mutation."""
        with self.scheduler.lock:
            if self.root is None:
                self._dirty_videos.clear()
                self._stale_policy_state.clear()
                self._catalog_dirty = False
                return
            self.root.mkdir(parents=True, exist_ok=True)
            names = set(self._videos) if full \
                else self._dirty_videos & set(self._videos)
            for name in sorted(names):
                doc = {"version": MANIFEST_VERSION, "name": name,
                       **self._entry_doc(self._videos[name])}
                _atomic_write_json(self.video_manifest_path(name), doc)
            self._stale_policy_state -= names  # state now durable
            if full or self._catalog_dirty or not self.catalog_path.exists():
                _atomic_write_json(self.catalog_path,
                                   {"version": MANIFEST_VERSION,
                                    "videos": self.videos()})
            self._dirty_videos.clear()
            self._catalog_dirty = False

    def _entry_doc(self, e: VideoEntry) -> dict:
        cm = e.cost_model
        return {
            "encoder": dataclasses.asdict(e.encoder),
            "sot_len": e.store.sot_len,
            "frame_hw": list(e.frame_hw) if e.frame_hw else None,
            "policy": policy_spec(e.policy),
            "cost_model": {"beta": cm.beta, "gamma": cm.gamma,
                           "r_squared": cm.r_squared,
                           "io_per_pixel": cm.io_per_pixel,
                           "encode_per_pixel": cm.encode_per_pixel,
                           "encode_per_tile": cm.encode_per_tile},
            "policy_state": e.policy.state_dict(),   # v3: runtime state
            "sots": [{"sot_id": r.sot_id, "frame_start": r.frame_start,
                      "frame_end": r.frame_end, "epoch": r.epoch,
                      "size_bytes": r.size_bytes,
                      "heights": list(r.layout.heights),
                      "widths": list(r.layout.widths)}
                     for r in e.store.sots],
            "index": e.index.dump(e.name),
        }

    def _entry_from_doc(self, name: str, v: dict, *,
                        tiles: Optional[dict] = None) -> VideoEntry:
        enc = EncoderConfig(**v["encoder"])
        cmd = v["cost_model"]
        cm = CostModel(beta=cmd["beta"], gamma=cmd["gamma"],
                       r_squared=cmd["r_squared"])
        # additive since the io term: older shards simply lack it (0.0)
        cm.io_per_pixel = cmd.get("io_per_pixel", 0.0)
        cm.encode_per_pixel = cmd["encode_per_pixel"]
        cm.encode_per_tile = cmd["encode_per_tile"]
        policy = policy_from_spec(v["policy"])
        # v3 persists policy runtime state; a v2 shard has none (cold start)
        policy.load_state(v.get("policy_state") or {})
        entry = VideoEntry(
            name=name, encoder=enc, policy=policy,
            cost_model=cm,
            store=TileStore(name, enc,
                            root=str(self.root) if self.root else None,
                            sot_len=v["sot_len"],
                            decode_backend=self.decode_backend,
                            device=self.decode_config.device),
            index=SemanticIndex(),
            frame_hw=tuple(v["frame_hw"]) if v["frame_hw"] else None)
        records = [
            SOTRecord(s["sot_id"], s["frame_start"], s["frame_end"],
                      TileLayout(tuple(s["heights"]), tuple(s["widths"])),
                      epoch=s["epoch"], size_bytes=s["size_bytes"])
            for s in v["sots"]]
        if tiles is None:
            # catalog reopen: tile data already in its on-disk home
            entry.store.restore(records)
        else:
            # replica import: materialize every tile stream from the staged
            # chunks (works for in-memory and on-disk stores alike), then
            # register the records
            for rec in records:
                for t in range(rec.layout.n_tiles):
                    entry.store._write_tile(
                        rec, t, tiles[(rec.sot_id, rec.epoch, t)])
                entry.store._register(rec)
        entry.index.load(name, v["index"])
        return entry

    def _load_catalog(self) -> None:
        doc = json.loads(self.catalog_path.read_text())
        if doc.get("version") not in COMPAT_SHARD_VERSIONS:
            raise ValueError(f"unsupported catalog version "
                             f"{doc.get('version')!r} in {self.catalog_path}")
        migrate = doc.get("version") != MANIFEST_VERSION
        for name in doc["videos"]:
            v = json.loads(self.video_manifest_path(name).read_text())
            if v.get("version") not in COMPAT_SHARD_VERSIONS:
                raise ValueError(
                    f"unsupported manifest version {v.get('version')!r} "
                    f"for video {name!r}")
            self._videos[name] = self._entry_from_doc(name, v)
            if v.get("version") != MANIFEST_VERSION:
                migrate = True
                self._dirty_videos.add(name)
        if migrate:
            # v2 -> v3 migration on open: rewrite old shards (policy state
            # starts cold — v2 never recorded it) and stamp the catalog v3
            self._catalog_dirty = True
            self.save()

    def _migrate_v1(self) -> None:
        """Adopt a v1 monolithic manifest and rewrite it as v2 per-video
        shards + catalog.  The old file is kept as ``manifest.json.v1.bak``;
        tile data is untouched (no re-ingest)."""
        legacy = self.legacy_manifest_path
        doc = json.loads(legacy.read_text())
        ver = doc.get("version")
        if ver != LEGACY_MANIFEST_VERSION:
            raise ValueError(f"cannot migrate manifest version {ver!r} "
                             f"at {legacy}")
        for name, v in doc["videos"].items():
            self._videos[name] = self._entry_from_doc(name, v)
        self._dirty_videos = set(self._videos)
        self._catalog_dirty = True
        self.save()
        legacy.rename(legacy.parent / (legacy.name + ".v1.bak"))


# ------------------------------------------------------------------ helpers
def _load_staged_tile(path: pathlib.Path):
    """Read one staged import chunk back and re-verify it against its
    stored checksum.  Returns ``(sot_id, epoch, tile_idx, enc, sha)`` or
    ``None`` for anything unreadable or torn (a SIGKILLed destination can
    leave both) — callers discard those and re-stream."""
    try:
        with np.load(path) as z:
            sot_id, epoch, tile_idx = (int(x) for x in z["key"])
            h, w, gop, qp, n_frames = (int(x) for x in z["meta"])
            n_gops = n_frames // gop
            enc = {"kq": [z[f"kq_{g}"] for g in range(n_gops)],
                   "pq": [z[f"pq_{g}"] for g in range(n_gops)],
                   "h": h, "w": w, "gop": gop, "qp": qp,
                   "n_frames": n_frames,
                   "size_bytes": float(z["size"][0])}
            sha = z["sha"].tobytes().decode()
        if tile_checksum(enc) != sha:
            return None
        return sot_id, epoch, tile_idx, enc, sha
    except Exception:
        return None


def _atomic_write_json(path: pathlib.Path, doc: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp"
    tmp.write_text(json.dumps(doc, indent=1))
    tmp.rename(path)


def _apply_limit(boxes_by_frame: dict[int, list], limit: int
                 ) -> dict[int, list]:
    """Keep at most ``limit`` regions, frames ascending (deterministic)."""
    out: dict[int, list] = {}
    left = limit
    for f in sorted(boxes_by_frame):
        if left <= 0:
            break
        take = boxes_by_frame[f][:left]
        out[f] = take
        left -= len(take)
    return out
