"""Declarative scan queries with an explicit plan/execute split.

The engine's query surface is a chainable builder::

    store.scan("cam0").labels("car").frames(0, 96).execute()
    store.scan(["cam0", "cam1"]).labels("car", "person").limit(32).explain()

Three stages, each a first-class object:

- :class:`ScanQuery`    — the builder; immutable, every chained call returns
                          a fresh query, so partial queries can be forked.
- :class:`ScanPlan`     — the *logical* plan: videos, CNF predicate, frame
                          range, limit.  No storage details.
- :class:`PhysicalPlan` — the lowered plan: the exact SOTs and tile indices
                          to decode per video, with pixel/tile/cost estimates
                          from the §4.1 what-if cost interface.  Produced by
                          ``VideoStore.lower``; ``.explain()`` returns it
                          without decoding anything.

Execution goes through the serving layer (``scheduler.py``): plans are
batches of explicit :class:`SOTScan` work units, so a scheduler can merge
overlapping SOT scans from concurrent queries into one decode and serve
repeat tiles from the epoch-keyed tile cache (``tile_cache.py``); see
``engine.py`` for the full picture.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.semantic_index import parse_predicate


# --------------------------------------------------------------------- stats
@dataclass
class ScanStats:
    """Per-query accounting.  ``pixels_decoded`` counts pixels *actually*
    decoded on behalf of this query, at 8x8-block granularity: an
    ROI-restricted fetch adds its masked blocks x frames, and a tile
    served from the cache (or an earlier consumer's decode in a merged
    batch) adds nothing — a fully warm repeat scan reports 0.  A
    covering-miss re-decode is charged in full: when the cache holds a
    partial entry the fetch widens to the union of the old and new masks
    at the max of both depths (entries never shrink), so the triggering
    query can be charged more than its own mask.  Like
    ``cache_misses``, shared fresh work is charged to the first query
    (submission order) that needed it, so summing over history counts each
    decoded block once.  For ``.decode(False)`` estimation-only scans it
    falls back to the plan's ``est_pixels``.  ``tiles_decoded`` stays the
    *planned* tile-stream-open estimate (it fills for estimation-only scans
    too).  ``cache_hits``/``cache_misses`` count what the serving layer
    actually did: of the tiles this query needed, how many were served from
    the tile cache (or a merged batch decode) vs freshly decoded.  A
    freshly decoded tile shared by several merged queries is charged as a
    miss only to the first query (submission order) that needed it;
    likewise in a merged batch each group's decode wall seconds land in the
    first consumer's ``decode_s``, so summing over history counts shared
    work once (a solo ``execute`` keeps the old wall-clock-of-decode-phase
    meaning).

    ``retile_s`` — seconds of policy-driven re-encoding charged to THIS
    query.  Non-zero only under ``tuning="inline"``, where re-tiles run
    synchronously inside the scan that triggered them.  Under
    ``tuning="background"`` (the ``VideoStore`` default) queries are never
    charged tuning work: re-tiles run on the tuner thread and are
    observable only via :class:`~repro_torch.core.tuner.TunerStats` and
    ``store.drain_tuner()``.

    ``marshal_s``/``payload_bytes``/``transport`` — reply-marshalling
    accounting, stamped by the serving layer as the result crosses a
    process boundary (all-zero/empty for in-process execution).
    ``marshal_s`` is seconds spent building the reply doc and packing its
    payload; ``payload_bytes`` is the packed size of the region arrays
    (npz blob bytes on the socket transport, raw shared bytes on shm);
    ``transport`` is ``"shm"`` or ``"npz"`` — what this result actually
    rode."""
    lookup_s: float = 0.0
    decode_s: float = 0.0
    retile_s: float = 0.0
    detect_s: float = 0.0
    pixels_decoded: float = 0.0
    tiles_decoded: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    regions: int = 0
    marshal_s: float = 0.0
    payload_bytes: float = 0.0
    transport: str = ""

    @property
    def tiles_fetched(self) -> int:
        """Tiles this query obtained through the serving layer."""
        return self.cache_hits + self.cache_misses

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.tiles_fetched if self.tiles_fetched \
            else 0.0

    @property
    def query_s(self) -> float:
        """Paper's per-query time: index lookup + decode."""
        return self.lookup_s + self.decode_s

    @property
    def total_s(self) -> float:
        return self.lookup_s + self.decode_s + self.retile_s + self.detect_s

    # -- wire ---------------------------------------------------------------
    def to_doc(self) -> dict:
        """JSON-able field dict (wire layer; properties recompute)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "ScanStats":
        return cls(**doc)


@dataclass
class ScanResult:
    regions: list  # (frame, bbox, pixels) — single video; see regions_by_video
    stats: ScanStats
    plan: Optional["PhysicalPlan"] = None
    regions_by_video: dict = field(default_factory=dict)

    # -- wire ---------------------------------------------------------------
    def to_doc(self, include_plan: bool = True) -> dict:
        """Wire doc: JSON-able except the region pixel arrays, which stay
        ``np.ndarray`` for the wire layer to pack into the frame's npz
        payload.  Only ``regions_by_video`` is serialized — the flat
        ``regions`` list shares its arrays and is rebuilt on the far side
        from the plan's video order, so each crop ships once.
        ``include_plan=False`` (clients with ``want_plans=False``) skips
        the O(regions) plan-doc marshalling entirely — it runs on the
        server's shared dispatcher thread."""
        videos = list(self.plan.logical.videos) if self.plan is not None \
            else sorted(self.regions_by_video)
        return {
            "videos": videos,
            "stats": self.stats.to_doc(),
            "plan": self.plan.to_doc()
            if include_plan and self.plan is not None else None,
            "rbv": {v: [[f, list(b), px] for f, b, px in rs]
                    for v, rs in self.regions_by_video.items()},
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "ScanResult":
        rbv = {v: [(int(f), tuple(b), px) for f, b, px in rs]
               for v, rs in doc["rbv"].items()}
        videos = list(doc["videos"])
        if len(videos) == 1:
            regions = list(rbv.get(videos[0], []))
        else:  # multi-video flat list prepends the video (scheduler order)
            regions = [(v, f, b, px) for v in videos
                       for f, b, px in rbv.get(v, [])]
        return cls(regions=regions,
                   stats=ScanStats.from_doc(doc["stats"]),
                   plan=PhysicalPlan.from_doc(doc["plan"])
                   if doc.get("plan") is not None else None,
                   regions_by_video=rbv)


# ------------------------------------------------------------- logical plan
@dataclass(frozen=True)
class ScanPlan:
    """Logical plan: what to retrieve, with no storage details."""
    videos: tuple[str, ...]
    cnf: tuple[tuple[str, ...], ...]          # CNF over labels; () = all
    frame_range: Optional[tuple[int, int]] = None
    limit: Optional[int] = None
    decode: bool = True

    @property
    def flat_labels(self) -> tuple[str, ...]:
        return tuple(sorted({l for clause in self.cnf for l in clause}))

    def describe(self) -> str:
        pred = " AND ".join("(" + " OR ".join(c) + ")" for c in self.cnf) \
            or "<all labels>"
        rng = f" FRAMES [{self.frame_range[0]}, {self.frame_range[1]})" \
            if self.frame_range else ""
        lim = f" LIMIT {self.limit}" if self.limit is not None else ""
        return f"SCAN {','.join(self.videos)} WHERE {pred}{rng}{lim}"

    # -- wire ---------------------------------------------------------------
    def to_doc(self) -> dict:
        return {"videos": list(self.videos),
                "cnf": [list(c) for c in self.cnf],
                "frame_range": list(self.frame_range)
                if self.frame_range else None,
                "limit": self.limit, "decode": self.decode}

    @classmethod
    def from_doc(cls, doc: dict) -> "ScanPlan":
        rng = doc.get("frame_range")
        return cls(videos=tuple(doc["videos"]),
                   cnf=tuple(tuple(c) for c in doc["cnf"]),
                   frame_range=(int(rng[0]), int(rng[1])) if rng else None,
                   limit=doc.get("limit"), decode=bool(doc.get("decode", True)))


# ------------------------------------------------------------ physical plan
@dataclass
class SOTScan:
    """One physical work unit: decode `tile_idxs` of one SOT.

    ``blocks_by_tile`` is the plan's block-coverage mask — for every tile in
    ``tile_idxs``, the sorted tuple of tile-local 8x8-block indices the
    query's boxes intersect, or ``None`` for "every block" (full-tile
    decode).  An *empty* dict marks a full-tile plan (``roi_decode=False``
    or a pre-ROI plan): the scheduler then decodes whole tiles, exactly the
    pre-ROI path.  Masks are minted against ``epoch``'s layout; a stale plan
    recomputes them from ``boxes_by_frame`` at fetch time."""
    video: str
    sot_id: int
    epoch: int                      # layout epoch the plan was made against
    tile_idxs: tuple[int, ...]
    n_frames: int                   # relative frames to decode (from SOT start)
    boxes_by_frame: dict            # frame -> [BBox], restricted to this SOT
    query_range: tuple[int, int]    # effective temporal range (for policies)
    labels: tuple[str, ...] = ()    # resolved flat labels (for policies)
    est_pixels: float = 0.0
    est_tiles: float = 0.0
    est_cost_s: float = 0.0
    blocks_by_tile: dict = field(default_factory=dict)

    # -- wire ---------------------------------------------------------------
    def to_doc(self) -> dict:
        """JSON-able doc.  Int-keyed dicts become ``[key, value]`` pair
        lists (JSON objects cannot key on ints) and block masks keep the
        ``None`` = every-block convention."""
        return {
            "video": self.video, "sot_id": self.sot_id, "epoch": self.epoch,
            "tile_idxs": list(self.tile_idxs), "n_frames": self.n_frames,
            "boxes_by_frame": [[f, [list(b) for b in boxes]]
                               for f, boxes in
                               sorted(self.boxes_by_frame.items())],
            "query_range": list(self.query_range),
            "labels": list(self.labels),
            "est_pixels": self.est_pixels, "est_tiles": self.est_tiles,
            "est_cost_s": self.est_cost_s,
            "blocks_by_tile": [[t, None if m is None else list(m)]
                               for t, m in
                               sorted(self.blocks_by_tile.items())],
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "SOTScan":
        return cls(
            video=doc["video"], sot_id=int(doc["sot_id"]),
            epoch=int(doc["epoch"]),
            tile_idxs=tuple(int(t) for t in doc["tile_idxs"]),
            n_frames=int(doc["n_frames"]),
            boxes_by_frame={int(f): [tuple(int(c) for c in b) for b in boxes]
                            for f, boxes in doc["boxes_by_frame"]},
            query_range=tuple(int(v) for v in doc["query_range"]),
            labels=tuple(doc["labels"]),
            est_pixels=doc["est_pixels"], est_tiles=doc["est_tiles"],
            est_cost_s=doc["est_cost_s"],
            blocks_by_tile={int(t): None if m is None
                            else tuple(int(b) for b in m)
                            for t, m in doc["blocks_by_tile"]})


@dataclass
class PhysicalPlan:
    """Lowered plan: exact SOTs/tiles to decode plus cost estimates."""
    logical: ScanPlan
    sot_scans: list[SOTScan] = field(default_factory=list)
    lookup_s: float = 0.0

    @property
    def est_pixels(self) -> float:
        return sum(s.est_pixels for s in self.sot_scans)

    @property
    def est_tiles(self) -> float:
        return sum(s.est_tiles for s in self.sot_scans)

    @property
    def est_cost_s(self) -> float:
        return sum(s.est_cost_s for s in self.sot_scans)

    @property
    def n_regions(self) -> int:
        return sum(len(b) for s in self.sot_scans
                   for b in s.boxes_by_frame.values())

    def describe(self) -> str:
        lines = [self.logical.describe()]
        for s in self.sot_scans:
            roi = ""
            if s.blocks_by_tile:
                n_sel = sum(len(m) for m in s.blocks_by_tile.values()
                            if m is not None)
                full = sum(1 for m in s.blocks_by_tile.values() if m is None)
                roi = f" blocks={n_sel}+{full}full" if full \
                    else f" blocks={n_sel}"
            lines.append(
                f"  {s.video} sot={s.sot_id} epoch={s.epoch} "
                f"tiles={list(s.tile_idxs)}{roi} frames<={s.n_frames} "
                f"~{s.est_pixels / 1e6:.2f}Mpx est={s.est_cost_s * 1e3:.2f}ms")
        lines.append(
            f"  total: {len(self.sot_scans)} SOTs, {self.est_tiles:.0f} tile "
            f"streams, {self.est_pixels / 1e6:.2f}Mpx, "
            f"est {self.est_cost_s * 1e3:.2f}ms, {self.n_regions} regions")
        return "\n".join(lines)

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.describe()

    # -- wire ---------------------------------------------------------------
    def to_doc(self) -> dict:
        return {"logical": self.logical.to_doc(), "lookup_s": self.lookup_s,
                "sot_scans": [s.to_doc() for s in self.sot_scans]}

    @classmethod
    def from_doc(cls, doc: dict) -> "PhysicalPlan":
        return cls(logical=ScanPlan.from_doc(doc["logical"]),
                   sot_scans=[SOTScan.from_doc(s) for s in doc["sot_scans"]],
                   lookup_s=doc.get("lookup_s", 0.0))


# ----------------------------------------------------- cluster split/merge
def split_plan(plan: ScanPlan, key_of) -> list[tuple[object, ScanPlan]]:
    """Split a multi-video logical plan into ``(key, subplan)`` runs for
    cross-node execution: consecutive videos sharing ``key_of(video)``
    (their owning node) form one subplan, in plan order.  Keeping the
    runs contiguous — rather than grouping all of a node's videos into
    one subplan — preserves the engine's *sequential* semantics exactly:
    executing the runs in list order visits videos in the same order a
    single store would, which is what makes a decremented ``limit``
    bit-identical (the engine spends the limit video-by-video in plan
    order).  The subplans inherit the parent's predicate/range/decode;
    the caller owns limit accounting across runs."""
    groups: list[tuple[object, list[str]]] = []
    for v in plan.videos:
        k = key_of(v)
        if groups and groups[-1][0] == k:
            groups[-1][1].append(v)
        else:
            groups.append((k, [v]))
    return [(k, dataclasses.replace(plan, videos=tuple(vs)))
            for k, vs in groups]


def merge_results(plan: ScanPlan, parts: list) -> ScanResult:
    """Re-assemble per-node partial :class:`ScanResult`\\ s of
    :func:`split_plan` subplans into one result for the original plan —
    bit-identical to a single store executing it: ``regions_by_video``
    is the union, the flat ``regions`` list is rebuilt in the parent
    plan's video order (multi-video tuples prepend the video name, the
    scheduler's convention), and stats fields are summed.  The merged
    physical plan concatenates the parts' SOT scans in run order when
    every part carried one (else ``None``)."""
    rbv: dict = {}
    for r in parts:
        rbv.update(r.regions_by_video)
    if len(plan.videos) == 1:
        regions = list(rbv.get(plan.videos[0], []))
    else:
        regions = [(v, f, b, px) for v in plan.videos
                   for f, b, px in rbv.get(v, [])]
    # numeric stats sum; the (string) transport field merges to the common
    # value when every part rode the same transport, else "mixed"
    transports = {r.stats.transport for r in parts if r.stats.transport}
    stats = ScanStats(**{
        f.name: sum(getattr(r.stats, f.name) for r in parts)
        for f in dataclasses.fields(ScanStats) if f.name != "transport"},
        transport=transports.pop() if len(transports) == 1
        else "mixed" if transports else "")
    merged_plan = None
    if parts and all(r.plan is not None for r in parts):
        merged_plan = PhysicalPlan(
            logical=plan,
            sot_scans=[s for r in parts for s in r.plan.sot_scans],
            lookup_s=sum(r.plan.lookup_s for r in parts))
    return ScanResult(regions=regions, stats=stats, plan=merged_plan,
                      regions_by_video=rbv)


# ------------------------------------------------------------------ builder
class ScanQuery:
    """Chainable, immutable scan-query builder bound to a ``VideoStore``.

    ``labels`` accepts a single label, several labels (one disjunctive
    clause, matching the old ``scan(["car", "person"])``), or a full CNF
    (sequence of clauses).  With no ``labels`` call the scan targets every
    label known to the index.
    """

    def __init__(self, engine, videos):
        self._engine = engine
        if isinstance(videos, str):
            videos = (videos,)
        self._videos: tuple[str, ...] = tuple(videos)
        self._cnf: Optional[tuple[tuple[str, ...], ...]] = None
        self._range: Optional[tuple[int, int]] = None
        self._limit: Optional[int] = None
        self._decode: bool = True

    # -- chain ---------------------------------------------------------------
    def _clone(self) -> "ScanQuery":
        # type(self): a RemoteScanQuery (client.py) forks into its own kind
        q = type(self)(self._engine, self._videos)
        q._cnf, q._range = self._cnf, self._range
        q._limit, q._decode = self._limit, self._decode
        return q

    def labels(self, *labels) -> "ScanQuery":
        q = self._clone()
        if not labels:
            q._cnf = ()  # sentinel: all labels, resolved at lowering
        elif len(labels) == 1 and not isinstance(labels[0], str):
            q._cnf = parse_predicate(labels[0])  # list or CNF
        else:
            q._cnf = parse_predicate(list(labels))  # one disjunctive clause
        return q

    def frames(self, lo: int, hi: int) -> "ScanQuery":
        if lo >= hi:
            raise ValueError(f"empty frame range [{lo}, {hi})")
        q = self._clone()
        q._range = (int(lo), int(hi))
        return q

    def limit(self, n: int) -> "ScanQuery":
        if n < 0:
            raise ValueError("limit must be >= 0")
        q = self._clone()
        q._limit = int(n)
        return q

    def decode(self, flag: bool = True) -> "ScanQuery":
        q = self._clone()
        q._decode = bool(flag)
        return q

    # -- plan / execute ------------------------------------------------------
    def plan(self) -> ScanPlan:
        if self._cnf is None:
            raise ValueError("no predicate: call .labels(...) before "
                             ".plan()/.explain()/.execute()")
        return ScanPlan(videos=self._videos, cnf=self._cnf,
                        frame_range=self._range, limit=self._limit,
                        decode=self._decode)

    def explain(self) -> PhysicalPlan:
        """Lower to a physical plan (SOTs, tiles, estimated cost) WITHOUT
        decoding, running policies, or recording history."""
        return self._engine.lower(self.plan())

    def execute(self) -> ScanResult:
        return self._engine.execute(self._engine.lower(self.plan()))

    # -- wire ---------------------------------------------------------------
    def to_doc(self) -> dict:
        """Builder state as a JSON-able doc (``cnf`` may still be unset —
        unlike :meth:`plan` this never raises, so partial queries ship)."""
        return {"videos": list(self._videos),
                "cnf": None if self._cnf is None
                else [list(c) for c in self._cnf],
                "frame_range": list(self._range) if self._range else None,
                "limit": self._limit, "decode": self._decode}

    @classmethod
    def from_doc(cls, engine, doc: dict) -> "ScanQuery":
        q = cls(engine, tuple(doc["videos"]))
        cnf = doc.get("cnf")
        q._cnf = None if cnf is None else tuple(tuple(c) for c in cnf)
        rng = doc.get("frame_range")
        q._range = (int(rng[0]), int(rng[1])) if rng else None
        lim = doc.get("limit")
        q._limit = None if lim is None else int(lim)
        q._decode = bool(doc.get("decode", True))
        return q
