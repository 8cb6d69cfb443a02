"""Distributed VideoStore: a router tier over N ``VideoStoreServer`` nodes.

One TASM node already serves many client processes (``server.py``), but a
single store caps out at one machine's decode throughput and loses
everything when its process dies.  This module scales the same declarative
surface horizontally — VSS-style, with the storage tier split from the
query tier:

- :class:`PlacementMap` — consistent hashing over video names with an
  *explicit, persisted* assignment table.  The sha1 ring (virtual nodes,
  deterministic across processes) proposes owners; a bounded-load walk
  (cap ``ceil((placed+1)/N)``) keeps primaries within one video of even,
  and the recorded assignment is what routing obeys — membership changes
  suggest moves (:meth:`PlacementMap.plan_rebalance`) but never silently
  re-home data.

- :class:`ClusterRouter` — duck-types the ``VideoStore`` surface the
  socket front end touches, so a stock :class:`VideoStoreServer` (or the
  thin :class:`ClusterRouterServer` subclass with placement introspection
  ops) can serve a whole cluster.  Scans route to the first live replica
  in placement order (primary first, so repeats land on a warm tile
  cache); ``execute_many`` batches fan out per node in one RPC each and
  results re-assemble in strict submission order; mutations
  (``ingest``/``add_detections``/``retile``/…) apply to every replica.
  Each node keeps its own scheduler, cache, and tuner.

- Replication: ``replication=K`` writes every mutation to K nodes.  A
  dead node is marked down and excluded from reads; a replica that missed
  a mutation is marked stale per video.  Failover is *epoch-checked*: the
  router tracks the layout-epoch table each video should have (ingest
  acks + its own retiles), and a replica whose epochs lag is never read —
  a pre-retile layout cannot be served.  Node epochs only grow (local
  tuners bump them independently), so the check is ``>=`` per SOT.

- :class:`ClusterClient` — ``RemoteVideoStore`` plus cluster
  introspection RPCs, for talking to a :class:`ClusterRouterServer`.

Results are bit-identical to a single in-process store: per-node results
are exact (``server.py``), and cross-node merges rebuild flat regions in plan
video order while spending ``limit`` sequentially per video — the
engine's own semantics (see ``query.split_plan``/``merge_results``).

In the port the router does no device work: it holds no store, never
touches a tensor and never creates a CUDA context.  Each node is a
``python -m repro_torch.tasm_serve`` process whose store decodes and
encodes on its own device, so several nodes may share one card.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import math
import os
import pathlib
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from repro_torch.core import wire
from repro_torch.core.client import RemoteVideoStore
from repro_torch.core.engine import IngestStats
from repro_torch.core.repair import RepairStats, RepairWorker
from repro_torch.core.query import (PhysicalPlan, ScanPlan, ScanQuery,
                                    ScanResult, ScanStats, merge_results,
                                    split_plan)
from repro_torch.core.server import VideoStoreServer
from repro_torch.core.tile_cache import CacheStats
from repro_torch.core.tuner import TunerStats

def _sum_cache_docs(docs) -> dict:
    """Aggregate per-node ``stats()["cache"]`` documents: counters and
    gauges add; ``evictions_by_reason`` merges per reason."""
    total = dataclasses.asdict(CacheStats())
    for d in docs:
        for k, v in d.items():
            if k == "evictions_by_reason":
                agg = total[k]
                for r, n in (v or {}).items():
                    agg[r] = agg.get(r, 0) + n
            elif k in total:
                total[k] += v
    return total


#: connection-level failures that trigger mark-down + failover (semantic
#: errors — KeyError, ValueError, … — always propagate to the caller)
_CONN_ERRORS = (wire.ConnectionClosed, wire.WireError, OSError)


def _ring_hash(key: str) -> int:
    """Deterministic across processes and runs (``hash()`` is salted)."""
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


def _parse_addr(addr) -> dict:
    """Node address → ``RemoteVideoStore`` kwargs: ``(host, port)`` tuple
    or ``"host:port"`` string = TCP, anything else = Unix socket path."""
    if isinstance(addr, (tuple, list)):
        return {"host": addr[0], "port": int(addr[1])}
    s = str(addr)
    if ":" in s and "/" not in s:
        host, port = s.rsplit(":", 1)
        return {"host": host or "127.0.0.1", "port": int(port)}
    return {"path": s}


def _map_threads(fn, items: list) -> list:
    """Apply ``fn`` concurrently on ephemeral threads (results in input
    order, first exception re-raised).  Ephemeral rather than pooled so
    nested fan-outs (a serving-session scan splitting across nodes) can
    never deadlock on exhausted pool workers."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    results: list = [None] * len(items)
    errs: list = []

    def run(i, x):
        try:
            results[i] = fn(x)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, x), daemon=True)
               for i, x in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return results


# ============================================================== placement
class PlacementMap:
    """Consistent-hash ring + explicit persisted video→nodes assignments.

    The ring (``vnodes`` virtual points per node, sha1) provides stable
    *proposals*: adding a node moves ~1/N of ring ownership
    (:meth:`ring_owner`).  Actual routing obeys :attr:`assignments`, an
    explicit table written at :meth:`place` time and persisted as JSON —
    so a membership change never silently re-homes ingested data; it only
    changes where *future* videos land, and :meth:`plan_rebalance` lists
    the deliberate moves that would re-align old ones.

    :meth:`place` walks ring successors skipping nodes already at the
    bounded-load cap ``ceil((placed+1)/N)``, which keeps primary counts
    within one of each other for any placement sequence.
    """

    def __init__(self, nodes, *, replication: int = 1, vnodes: int = 64,
                 path: Optional[str] = None):
        self.replication = int(replication)
        self.vnodes = int(vnodes)
        self.path = path
        self.nodes: list[str] = []
        for n in nodes:
            if n in self.nodes:
                raise ValueError(f"duplicate node {n!r}")
            self.nodes.append(n)
        self.assignments: dict[str, list[str]] = {}
        self._rebuild_ring()

    # ----------------------------------------------------------- the ring
    def _rebuild_ring(self) -> None:
        self._ring = sorted(
            (_ring_hash(f"{n}#{i}"), n)
            for n in self.nodes for i in range(self.vnodes))

    def _ring_walk(self, key: str):
        """Nodes in ring-successor order from ``key``'s point, each once."""
        if not self._ring:
            return
        idx = bisect.bisect_right(self._ring, (_ring_hash(key), "￿"))
        seen: set[str] = set()
        n_pts = len(self._ring)
        for off in range(n_pts):
            node = self._ring[(idx + off) % n_pts][1]
            if node not in seen:
                seen.add(node)
                yield node

    def ring_owner(self, video: str) -> str:
        """Pure consistent hash, no load bound, no memory — the stability
        anchor (adding a node re-homes ~1/N of these)."""
        for n in self._ring_walk(video):
            return n
        raise ValueError("placement map has no nodes")

    def ring_replicas(self, video: str, k: Optional[int] = None
                      ) -> list[str]:
        """First ``k`` distinct ring successors (pure CH, no memory)."""
        k = self.replication if k is None else int(k)
        out: list[str] = []
        for n in self._ring_walk(video):
            out.append(n)
            if len(out) >= k:
                break
        return out

    # --------------------------------------------------------- membership
    def add_node(self, name: str) -> None:
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        self.nodes.append(name)
        self._rebuild_ring()
        self.save()

    def remove_node(self, name: str) -> None:
        """Drop a node from the ring.  Existing assignments still naming
        it are untouched — migrating them is a deliberate operation (see
        :meth:`plan_rebalance`), not a side effect."""
        self.nodes.remove(name)
        self._rebuild_ring()
        self.save()

    # ---------------------------------------------------------- placement
    def place(self, video: str, *, replication: Optional[int] = None
              ) -> list[str]:
        """Return ``video``'s replica list, assigning it first if new.

        Primary: first ring successor under the bounded-load cap
        ``ceil((placed+1)/N)`` — max-min primary spread ≤ 1 for any
        sequence.  Replicas: the next distinct ring successors.  The
        assignment is recorded and persisted; repeat calls return it
        unchanged."""
        if video in self.assignments:
            return list(self.assignments[video])
        if not self.nodes:
            raise ValueError("placement map has no nodes")
        k = min(len(self.nodes),
                self.replication if replication is None
                else int(replication))
        counts = {n: 0 for n in self.nodes}
        for reps in self.assignments.values():
            if reps and reps[0] in counts:
                counts[reps[0]] += 1
        cap = math.ceil((len(self.assignments) + 1) / len(self.nodes))
        primary = next(n for n in self._ring_walk(video)
                       if counts[n] < cap)
        reps = [primary] + [n for n in self._ring_walk(video)
                            if n != primary][:k - 1]
        self.assignments[video] = reps
        self.save()
        return list(reps)

    def assign(self, video: str, nodes) -> None:
        """Explicitly pin a video's replica list (rebalance application)."""
        nodes = list(nodes)
        unknown = [n for n in nodes if n not in self.nodes]
        if unknown:
            raise ValueError(f"unknown nodes {unknown}")
        self.assignments[video] = nodes
        self.save()

    def nodes_for(self, video: str) -> list[str]:
        return list(self.assignments.get(video, []))

    def primary(self, video: str) -> Optional[str]:
        reps = self.assignments.get(video)
        return reps[0] if reps else None

    def plan_rebalance(self) -> dict[str, tuple[str, str]]:
        """``video -> (current primary, ring owner)`` for every video the
        pure ring would now place elsewhere.  Returned, never applied —
        moving data is the operator's call (:meth:`assign` after copying)."""
        return {v: (reps[0], self.ring_owner(v))
                for v, reps in self.assignments.items()
                if reps and reps[0] != self.ring_owner(v)}

    # -------------------------------------------------------- persistence
    def to_doc(self) -> dict:
        return {"version": 1, "nodes": list(self.nodes),
                "replication": self.replication, "vnodes": self.vnodes,
                "assignments": {v: list(r)
                                for v, r in self.assignments.items()}}

    @classmethod
    def from_doc(cls, doc: dict, *, path: Optional[str] = None
                 ) -> "PlacementMap":
        pm = cls(doc["nodes"], replication=doc.get("replication", 1),
                 vnodes=doc.get("vnodes", 64))
        pm.assignments = {v: list(r)
                          for v, r in doc.get("assignments", {}).items()}
        pm.path = path
        return pm

    def save(self) -> None:
        """Durable write: temp file + fsync + atomic rename (+ best-effort
        directory fsync), so a crash — even a power loss — mid-save leaves
        either the old table or the new one, never a torn file.  The
        assignment table is what routing obeys; a torn table would orphan
        every video."""
        if self.path is None:
            return
        p = pathlib.Path(self.path)
        tmp = p.with_suffix(p.suffix + ".tmp")
        with open(tmp, "w") as fh:
            fh.write(json.dumps(self.to_doc(), indent=1, sort_keys=True))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, p)
        try:  # the rename itself must survive a power loss too
            dfd = os.open(str(p.parent), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # pragma: no cover - dir fsync is best-effort
            pass

    @classmethod
    def load(cls, path: str) -> "PlacementMap":
        with open(path) as fh:
            doc = json.load(fh)
        return cls.from_doc(doc, path=path)


# ================================================================= router
class ClusterScanQuery(ScanQuery):
    """The chainable builder, routed through the cluster."""

    def explain(self) -> PhysicalPlan:
        return self._engine.lower(self.plan())

    def execute(self) -> ScanResult:
        return self._engine.execute(self.plan())

    def submit(self) -> Future:
        return self._engine.submit(self.plan())


class RouterServingSession:
    """``serve()`` over the cluster: ``submit`` returns a Future.  Each
    submission routes independently; per-node micro-batching happens on
    the nodes' own shared sessions, so concurrent submissions hitting one
    node still merge into union-of-tiles decodes there."""

    def __init__(self, router: "ClusterRouter"):
        self._router = router
        self._futs: list[Future] = []
        self._lock = threading.Lock()
        self._closed = False

    def submit(self, query) -> Future:
        with self._lock:
            if self._closed:
                raise RuntimeError("serving session is closed")
            fut = self._router.submit(query)
            self._futs.append(fut)
            return fut

    def execute(self, query) -> ScanResult:
        return self.submit(query).result()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            futs = list(self._futs)
        for f in futs:
            try:
                f.result()
            except Exception:  # noqa: BLE001 - surfaced via the future
                pass

    def __enter__(self) -> "RouterServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ClusterRouter:
    """Route the ``VideoStore`` surface across N remote nodes.

    ``nodes`` maps node name → address (Unix socket path, ``"host:port"``,
    or ``(host, port)``).  The placement map comes from ``placement=``,
    is loaded from ``placement_path`` when that file exists, or is built
    fresh over the given nodes with ``replication=K``.

    Duck-types everything :class:`VideoStoreServer` touches, so the
    router can sit directly behind the node's socket front end — clients
    cannot tell a cluster from a single store (results are
    bit-identical).  Thread-safe; reads fail over across replicas, and a
    node that dies mid-call is marked down and excluded until
    :meth:`ping_nodes` sees it answer again.
    """

    def __init__(self, nodes: dict, *, replication: int = 1,
                 placement: Optional[PlacementMap] = None,
                 placement_path: Optional[str] = None,
                 codec: Optional[str] = None,
                 max_frame_bytes: int = wire.DEFAULT_MAX_FRAME_BYTES,
                 node_retries: int = 1, timeout: Optional[float] = None,
                 health_interval: Optional[float] = None):
        """``timeout`` is the per-node connect timeout AND per-RPC
        deadline (a hung node fails over instead of blocking a serving
        thread; see ``RemoteVideoStore``).  ``health_interval`` starts a
        background health loop probing every node about that often
        (jittered) so recovered nodes rejoin automatically; down nodes
        are probed with exponential backoff.  ``None`` (default) keeps
        revival explicit via :meth:`ping_nodes`."""
        if not nodes:
            raise ValueError("cluster needs at least one node")
        self.addresses = dict(nodes)
        self.codec = codec
        self.max_frame_bytes = int(max_frame_bytes)
        self.node_retries = int(node_retries)
        self.timeout = timeout
        self.health_interval = health_interval
        if placement is None:
            if placement_path is not None and os.path.exists(placement_path):
                placement = PlacementMap.load(placement_path)
            else:
                placement = PlacementMap(sorted(self.addresses),
                                         replication=replication,
                                         path=placement_path)
        unknown = [n for n in placement.nodes if n not in self.addresses]
        if unknown:
            raise ValueError(f"placement names unknown nodes {unknown}")
        self.placement = placement
        self._lock = threading.RLock()
        self._channels: dict[str, RemoteVideoStore] = {}
        self._down: set[str] = set()
        self._stale: set[tuple[str, str]] = set()     # (video, node)
        self._verified: set[tuple[str, str]] = set()  # epoch-checked pairs
        self._epochs: dict[str, dict[int, int]] = {}  # expected generation
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, 4 * len(self.addresses)),
            thread_name_prefix="tasm-router")
        self.repairer: Optional[RepairWorker] = None  # lazily started
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._health_next: dict[str, float] = {}   # down-node probe gate
        self._health_backoff: dict[str, float] = {}
        for name in self.addresses:  # eager dial; down nodes mark themselves
            try:
                self._channel(name)
            except OSError:
                self._down.add(name)
        if health_interval is not None:
            self._health_thread = threading.Thread(
                target=self._health_loop, name="tasm-router-health",
                daemon=True)
            self._health_thread.start()

    # ------------------------------------------------------------ channels
    def _channel(self, name: str) -> RemoteVideoStore:
        with self._lock:
            if self._closed:
                raise RuntimeError("cluster router is closed")
            ch = self._channels.get(name)
            if ch is None:
                # want_plans=True is load-bearing: multi-video results
                # rebuild their flat region list from the plan's video
                # order, and merges re-serialize through to_doc
                ch = RemoteVideoStore(
                    codec=self.codec, max_frame_bytes=self.max_frame_bytes,
                    want_plans=True, retries=self.node_retries,
                    timeout=self.timeout, **_parse_addr(self.addresses[name]))
                self._channels[name] = ch
            return ch

    def _mark_down(self, name: str) -> None:
        with self._lock:
            self._down.add(name)
            ch = self._channels.pop(name, None)
        if ch is not None:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass

    def ping_nodes(self) -> dict[str, bool]:
        """Health-probe every node.  A node that answers rejoins the read
        set (per-video staleness marks survive — a revived node that
        missed a mutation stays excluded for those videos)."""
        out: dict[str, bool] = {}
        for name in sorted(self.addresses):
            try:
                self._channel(name).ping()
                with self._lock:
                    self._down.discard(name)
                out[name] = True
            except _CONN_ERRORS:
                self._mark_down(name)
                out[name] = False
        return out

    def _health_loop(self) -> None:
        """Periodic background ``ping_nodes``: live nodes are probed every
        (jittered) interval so a hang/death is noticed off the serving
        path, and down nodes rejoin automatically when they answer —
        probed with exponential backoff so a corpse isn't hammered."""
        interval = float(self.health_interval)
        while not self._health_stop.wait(interval *
                                         random.uniform(0.75, 1.25)):
            with self._lock:
                if self._closed:
                    return
                down = set(self._down)
            now = time.monotonic()
            for name in sorted(self.addresses):
                if name in down and now < self._health_next.get(name, 0.0):
                    continue
                try:
                    self._channel(name).ping()
                    with self._lock:
                        self._down.discard(name)
                    self._health_backoff.pop(name, None)
                    self._health_next.pop(name, None)
                except _CONN_ERRORS:
                    self._mark_down(name)
                    b = min(self._health_backoff.get(name, interval) * 2,
                            interval * 16)
                    self._health_backoff[name] = b
                    self._health_next[name] = time.monotonic() + b

    def _dial_node(self, name: str) -> RemoteVideoStore:
        """A FRESH connection to one node — repair streams ride their own
        socket (caller closes it) so bulk chunk frames never head-of-line
        block the shared serving channel."""
        with self._lock:
            if self._closed:
                raise RuntimeError("cluster router is closed")
            addr = self.addresses[name]
        return RemoteVideoStore(
            codec=self.codec, max_frame_bytes=self.max_frame_bytes,
            want_plans=True, timeout=self.timeout, **_parse_addr(addr))

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            chans = list(self._channels.values())
            self._channels.clear()
            repairer = self.repairer
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
        if repairer is not None:
            repairer.stop()
        self._pool.shutdown(wait=True)
        for ch in chans:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass

    def __enter__(self) -> "ClusterRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- read side
    def _reader_name(self, video: str) -> Optional[str]:
        """First live, non-stale replica in placement order — primary
        first, so repeat scans land on a warm tile cache.  ``None`` if no
        replica currently qualifies; KeyError if the video is unplaced."""
        reps = self.placement.nodes_for(video)
        if not reps:
            raise KeyError(f"unknown video {video!r}")
        with self._lock:
            for n in reps:
                if n not in self._down and (video, n) not in self._stale:
                    return n
        return None

    def _ensure_consistent(self, video: str, name: str,
                           ch: RemoteVideoStore) -> bool:
        """Epoch-check a replica before first reading a video from it.
        The primary is authoritative (mutations land there first, and a
        primary that missed one is already stale-marked); any other
        replica must prove its epoch table covers every mutation the
        router has acknowledged — ``>=`` per SOT, because local tuners
        bump epochs independently of the router."""
        if name == self.placement.primary(video):
            return True
        with self._lock:
            if (video, name) in self._verified:
                return True
            expected = dict(self._epochs.get(video) or {})
        if expected:
            try:
                have = ch.epochs(video)
            except _CONN_ERRORS:
                self._mark_down(name)
                return False
            except KeyError:
                with self._lock:
                    self._stale.add((video, name))
                return False
            if not all(have.get(s, -1) >= e for s, e in expected.items()):
                with self._lock:  # pre-retile generation: never serve it
                    self._stale.add((video, name))
                return False
        with self._lock:
            self._verified.add((video, name))
        return True

    def _on_video(self, video: str, fn):
        """Run ``fn(channel)`` against the first consistent live replica,
        failing over on connection errors (the failed node is marked down
        so the next candidate is tried)."""
        last_err: Optional[BaseException] = None
        for _ in range(len(self.addresses) + 1):
            name = self._reader_name(video)
            if name is None:
                break
            try:
                ch = self._channel(name)
            except OSError as e:
                self._mark_down(name)
                last_err = e
                continue
            if not self._ensure_consistent(video, name, ch):
                last_err = last_err or wire.ConnectionClosed(
                    f"replica {name} is stale for {video!r}")
                continue
            try:
                return fn(ch)
            except _CONN_ERRORS as e:
                self._mark_down(name)
                last_err = e
        raise last_err or wire.ConnectionClosed(
            f"no live replica serves {video!r}")

    def _single_reader(self, videos) -> Optional[tuple[str,
                                                       RemoteVideoStore]]:
        """The one node currently serving ALL of ``videos``, epoch-checked
        — the fast path that forwards a whole plan in one RPC (and lets
        the node apply multi-video ``limit`` natively)."""
        names = set()
        for v in videos:
            n = self._reader_name(v)
            if n is None:
                return None
            names.add(n)
        if len(names) != 1:
            return None
        name = names.pop()
        try:
            ch = self._channel(name)
        except OSError:
            self._mark_down(name)
            return None
        if not all(self._ensure_consistent(v, name, ch) for v in videos):
            return None
        return name, ch

    # ---------------------------------------------------------------- scan
    def scan(self, videos, labels=None,
             frames: Optional[tuple[int, int]] = None) -> ClusterScanQuery:
        q = ClusterScanQuery(self, videos)
        if labels is not None:
            q = q.labels(labels)
        if frames is not None:
            q = q.frames(*frames)
        return q

    @staticmethod
    def _as_plan(query) -> ScanPlan:
        if isinstance(query, PhysicalPlan):
            return query.logical
        if isinstance(query, ScanQuery):
            return query.plan()
        if isinstance(query, ScanPlan):
            return query
        raise TypeError(f"cannot route {type(query).__name__}; want "
                        "ScanQuery, ScanPlan, or PhysicalPlan")

    def execute(self, query) -> ScanResult:
        return self._execute_plan(self._as_plan(query))

    def submit(self, query) -> Future:
        """Fire-and-collect on the router's pool (serving sessions)."""
        plan = self._as_plan(query)
        return self._pool.submit(self._execute_plan, plan)

    def serve(self, **_kw) -> RouterServingSession:
        """Concurrent-submission session (``max_batch`` etc. are node-side
        concerns: each node's shared session micro-batches its share)."""
        return RouterServingSession(self)

    def _execute_plan(self, plan: ScanPlan) -> ScanResult:
        one = self._single_reader(plan.videos)
        if one is not None:
            name, ch = one
            try:
                return ch.execute(plan)
            except _CONN_ERRORS:
                self._mark_down(name)  # fall through to per-video failover
        parts = split_plan(plan, lambda v: v)  # per-video routing units
        if len(parts) == 1:
            return self._exec_one(parts[0][1])
        if plan.limit is not None:
            # the engine spends a limit video-by-video in plan order;
            # sequential execution with a decremented budget reproduces
            # that exactly across nodes
            results, remaining = [], int(plan.limit)
            for _, sub in parts:
                if remaining <= 0:
                    results.append(ScanResult(
                        regions=[], stats=ScanStats(),
                        plan=PhysicalPlan(logical=sub),
                        regions_by_video={}))
                    continue
                r = self._exec_one(dataclasses.replace(sub,
                                                       limit=remaining))
                remaining -= sum(len(rs)
                                 for rs in r.regions_by_video.values())
                results.append(r)
            return merge_results(plan, results)
        results = _map_threads(self._exec_one, [sub for _, sub in parts])
        return merge_results(plan, results)

    def _exec_one(self, sub: ScanPlan) -> ScanResult:
        return self._on_video(sub.videos[0], lambda ch: ch.execute(sub))

    def execute_many(self, queries) -> list[ScanResult]:
        """Fan the batch out per node — each node gets ONE execute_many
        RPC with its plans (one submission wave into its shared session,
        so they micro-batch there) — and re-assemble results in strict
        submission order.  Cross-node plans and plans whose node dies
        mid-batch fall back to routed per-plan execution."""
        plans = [self._as_plan(q) for q in queries]
        results: list[Optional[ScanResult]] = [None] * len(plans)
        groups: dict[str, list[int]] = {}
        solo: list[int] = []
        for i, p in enumerate(plans):
            names = {self._reader_name(v) for v in p.videos}
            if len(names) == 1 and None not in names:
                groups.setdefault(names.pop(), []).append(i)
            else:
                solo.append(i)

        def run_batch(item):
            name, idxs = item
            try:
                ch = self._channel(name)
                vids = {v for i in idxs for v in plans[i].videos}
                if all(self._ensure_consistent(v, name, ch) for v in vids):
                    return list(zip(
                        idxs, ch.execute_many([plans[i] for i in idxs])))
            except _CONN_ERRORS:
                self._mark_down(name)
            return [(i, self._execute_plan(plans[i])) for i in idxs]

        for out in _map_threads(run_batch, list(groups.items())):
            for i, r in out:
                results[i] = r
        for i in solo:
            results[i] = self._execute_plan(plans[i])
        return results

    def lower(self, plan) -> PhysicalPlan:
        """Explain across the cluster: single-node plans lower remotely
        in one RPC; cross-node plans concatenate per-video lowerings."""
        plan = self._as_plan(plan)
        one = self._single_reader(plan.videos)
        if one is not None:
            name, ch = one
            try:
                return ch._explain(plan)
            except _CONN_ERRORS:
                self._mark_down(name)
        parts = [self._on_video(sub.videos[0],
                                lambda ch, s=sub: ch._explain(s))
                 for _, sub in split_plan(plan, lambda v: v)]
        return PhysicalPlan(
            logical=plan,
            sot_scans=[s for p in parts for s in p.sot_scans],
            lookup_s=sum(p.lookup_s for p in parts))

    # ------------------------------------------------------------ mutation
    def _mutate(self, video: str, fn):
        """Apply a mutation to every replica.  Succeeds if at least one
        replica applied it; replicas that failed at the connection level
        are marked down AND stale for this video (they missed a write and
        must not serve it).  Semantic errors propagate immediately —
        replicas hold identical state, so the first node's verdict is
        the cluster's."""
        reps = self.placement.nodes_for(video)
        if not reps:
            raise KeyError(f"unknown video {video!r}")
        result, applied = None, False
        first_err: Optional[BaseException] = None
        for node in reps:
            with self._lock:
                down = node in self._down
            if down:
                with self._lock:
                    self._stale.add((video, node))
                continue
            try:
                r = fn(self._channel(node))
            except _CONN_ERRORS as e:
                self._mark_down(node)
                with self._lock:
                    self._stale.add((video, node))
                first_err = first_err or e
                continue
            if not applied:
                result, applied = r, True
        if not applied:
            raise first_err or wire.ConnectionClosed(
                f"no live replica of {video!r}")
        with self._lock:  # epoch tables may have moved: re-verify replicas
            self._verified = {(v, n) for v, n in self._verified
                              if v != video}
        return result

    def add_video(self, name: str, *, encoder=None, policy=None,
                  cost_model=None, sot_len=None) -> None:
        self.placement.place(name)
        self._mutate(name, lambda ch: ch.add_video(
            name, encoder=encoder, policy=policy, cost_model=cost_model,
            sot_len=sot_len))

    def ingest(self, name: str, frames, *, detections=None,
               initial_layouts=None, **video_kw) -> IngestStats:
        """Write all replicas; the acknowledged epoch tables must agree
        (same physical generation everywhere) and become the expected
        table failover verifies against."""
        self.placement.place(name)
        acks: dict[str, dict[int, int]] = {}

        def one(ch):
            s = ch.ingest(name, frames, detections=detections,
                          initial_layouts=initial_layouts, **video_kw)
            return s, ch.last_ingest_epochs

        stats, table = None, None
        reps = self.placement.nodes_for(name)
        first_err: Optional[BaseException] = None
        for node in reps:
            with self._lock:
                down = node in self._down
            if down:
                with self._lock:
                    self._stale.add((name, node))
                continue
            try:
                s, t = one(self._channel(node))
            except _CONN_ERRORS as e:
                self._mark_down(node)
                with self._lock:
                    self._stale.add((name, node))
                first_err = first_err or e
                continue
            acks[node] = t
            if stats is None:
                stats, table = s, t
        if stats is None:
            raise first_err or wire.ConnectionClosed(
                f"no live replica accepted ingest of {name!r}")
        if any(t != table for t in acks.values()):
            raise RuntimeError(
                f"replica epoch tables diverged ingesting {name!r}: {acks}")
        with self._lock:
            self._epochs[name] = dict(table)
            self._verified = {(v, n) for v, n in self._verified
                              if v != name}
        return stats

    def add_detections(self, video: str, detections_by_frame: dict) -> None:
        self._mutate(video, lambda ch: ch.add_detections(
            video, detections_by_frame))

    def add_metadata(self, video: str, frame: int, label: str,
                     x1: int, y1: int, x2: int, y2: int) -> None:
        self._mutate(video, lambda ch: ch.add_metadata(
            video, frame, label, x1, y1, x2, y2))

    def retile(self, video: str, sot_id: int, new_layout) -> float:
        dt = self._mutate(video,
                          lambda ch: ch.retile(video, sot_id, new_layout))
        if dt:  # layout actually changed: every replica bumped this SOT
            with self._lock:
                tbl = self._epochs.setdefault(video, {})
                tbl[int(sot_id)] = tbl.get(int(sot_id), 0) + 1
        return dt

    # -------------------------------------------------- repair / rebalance
    def _repair_worker(self) -> RepairWorker:
        with self._lock:
            if self._closed:
                raise RuntimeError("cluster router is closed")
            if self.repairer is None:
                self.repairer = RepairWorker(self)
            return self.repairer

    def expected_epochs(self, video: str) -> dict[int, int]:
        """The layout-generation table this video is expected to serve
        (ingest acks + router-acknowledged retiles) — what failover and
        the repair commit verify against."""
        with self._lock:
            return dict(self._epochs.get(video) or {})

    def _repair_source(self, video: str, *, exclude=()) -> Optional[str]:
        """Next live, non-stale replica a copy can stream from."""
        exclude = set(exclude)
        with self._lock:
            for n in self.placement.nodes_for(video):
                if n in exclude or n in self._down:
                    continue
                if (video, n) in self._stale:
                    continue
                return n
        return None

    def _apply_repair(self, job) -> None:
        """Flip placement after a verified copy: ``dst`` joins the
        replica list (first for moves — it's the new primary), the dead
        replicas this copy replaced leave it.  Verified marks clear so
        the epoch check runs against the fresh replica before its first
        read — a rebuilt replica can never serve a pre-retile
        generation."""
        with self._lock:
            drop = set(job.drop)
            reps = [n for n in self.placement.nodes_for(job.video)
                    if n != job.dst and n not in drop]
            reps = [job.dst] + reps if job.dst_primary else reps + [job.dst]
            self.placement.assign(job.video, reps)
            self._stale = {(v, n) for v, n in self._stale
                           if not (v == job.video and n == job.dst)}
            self._verified = {(v, n) for v, n in self._verified
                              if v != job.video}

    def repair(self, video: Optional[str] = None,
               node: Optional[str] = None) -> list[dict]:
        """Enqueue background copy jobs restoring the replication factor.
        ``video=`` heals one video; ``node=`` treats that node as
        permanently lost and re-replicates everything it held; neither
        heals every under-replicated video (currently-down nodes count as
        lost).  Returns the enqueued job descriptors immediately — the
        copies run off the serving path; poll :meth:`repair_status` (or
        :meth:`drain_repair`) for completion.  Reads keep routing to live
        replicas throughout, and each video's assignment only flips after
        its copy verifies."""
        with self._lock:
            lost = set(self._down)
        if node is not None:
            if node not in self.addresses:
                raise KeyError(f"unknown node {node!r}")
            lost.add(node)
        if video is not None:
            if video not in self.placement.assignments:
                raise KeyError(f"unknown video {video!r}")
            targets = [video]
        else:
            targets = sorted(self.placement.assignments)
        jobs = []
        for v in targets:
            reps = self.placement.nodes_for(v)
            live = [n for n in reps if n not in lost]
            k = min(self.placement.replication,
                    len([n for n in self.addresses if n not in lost]))
            if len(live) >= k:
                continue
            src = self._repair_source(v, exclude=lost)
            drop = tuple(n for n in reps if n in lost)
            candidates = [n for n in self.placement._ring_walk(v)
                          if n not in lost and n not in reps]
            worker = self._repair_worker()
            for dst in candidates[:k - len(live)]:
                jobs.append(worker.submit(v, src or "", dst,
                                          kind="replicate", drop=drop))
        return [j.describe() for j in jobs]

    def rebalance(self, apply: bool = False) -> dict:
        """The moves :meth:`PlacementMap.plan_rebalance` suggests — and,
        with ``apply=True``, their application: each moved video streams
        to its ring owner in the background and flips to it as primary
        only after verification.  A ring owner that already holds a
        replica flips immediately (no data to move)."""
        moves = self.placement.plan_rebalance()
        doc: dict = {"moves": {v: list(m) for v, m in sorted(moves.items())},
                     "applied": bool(apply), "jobs": [], "flipped": []}
        if not apply:
            return doc
        with self._lock:
            lost = set(self._down)
        k = self.placement.replication
        for v, (_cur, new) in sorted(moves.items()):
            reps = self.placement.nodes_for(v)
            if new in reps:
                with self._lock:
                    self.placement.assign(
                        v, [new] + [n for n in reps if n != new])
                    self._verified = {(vv, n) for vv, n in self._verified
                                      if vv != v}
                doc["flipped"].append(v)
                continue
            if new in lost:
                continue    # cannot move onto a dead node; plan again later
            src = self._repair_source(v, exclude={new})
            worker = self._repair_worker()
            # dst becomes primary; the old replica list is kept behind it,
            # trimmed back to K
            doc["jobs"].append(worker.submit(
                v, src or "", new, kind="move", drop=tuple(reps[k - 1:]),
                dst_primary=True).describe())
        return doc

    def repair_status(self) -> dict:
        """Per-job progress (chunks/bytes/retries/re-streams) plus
        worker-lifetime totals — the admin RPC the CLI polls."""
        with self._lock:
            worker = self.repairer
        if worker is None:
            return {"jobs": [], "stats": dataclasses.asdict(RepairStats())}
        return {"jobs": worker.jobs(),
                "stats": dataclasses.asdict(worker.stats())}

    def drain_repair(self, timeout: Optional[float] = None) -> dict:
        """Barrier: wait for every queued copy to finish, then return
        :meth:`repair_status`.  Re-raises the most recent job failure."""
        with self._lock:
            worker = self.repairer
        if worker is not None:
            worker.drain(timeout)
        return self.repair_status()

    def join_node(self, name: str, addr) -> dict:
        """Register a node at runtime: address book + placement ring.
        Existing assignments are untouched (future placements may land on
        it, and :meth:`repair` / :meth:`rebalance` can copy onto it)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("cluster router is closed")
            known = self.addresses.get(name)
            if known is not None and known != addr:
                raise ValueError(
                    f"node {name!r} is already registered at {known!r}")
            self.addresses[name] = addr
            if name not in self.placement.nodes:
                self.placement.add_node(name)
        try:
            self._channel(name).ping()
            with self._lock:
                self._down.discard(name)
            alive = True
        except _CONN_ERRORS:
            self._mark_down(name)
            alive = False
        return {"node": name, "alive": alive,
                "nodes": sorted(self.addresses)}

    # ------------------------------------------------------------- tuning
    def _sum_tuner(self, fn) -> TunerStats:
        total = TunerStats()
        for name in sorted(self.addresses):
            with self._lock:
                if name in self._down:
                    continue
            try:
                t = fn(self._channel(name))
            except _CONN_ERRORS:
                self._mark_down(name)
                continue
            for f in dataclasses.fields(TunerStats):
                setattr(total, f.name,
                        getattr(total, f.name) + getattr(t, f.name))
        return total

    def drain_tuner(self, timeout: Optional[float] = None) -> TunerStats:
        return self._sum_tuner(lambda ch: ch.drain_tuner(timeout))

    def tuner_stats(self) -> TunerStats:
        return self._sum_tuner(lambda ch: ch.tuner_stats())

    def _sum_cache(self, fn) -> CacheStats:
        """Sum one :class:`CacheStats` per live node (counters add;
        ``evictions_by_reason`` merges per reason)."""
        total = CacheStats()
        for name in sorted(self.addresses):
            with self._lock:
                if name in self._down:
                    continue
            try:
                c = fn(self._channel(name))
            except _CONN_ERRORS:
                self._mark_down(name)
                continue
            for f in dataclasses.fields(CacheStats):
                if f.name == "evictions_by_reason":
                    for r, n in c.evictions_by_reason.items():
                        total.evictions_by_reason[r] = \
                            total.evictions_by_reason.get(r, 0) + n
                else:
                    setattr(total, f.name,
                            getattr(total, f.name) + getattr(c, f.name))
        return total

    def drain_prefetch(self, timeout: Optional[float] = None) -> CacheStats:
        """Prefetch barrier across every live node; summed cache stats."""
        return self._sum_cache(lambda ch: ch.drain_prefetch(timeout))

    def config(self) -> dict:
        """Per-node resolved configuration documents (``None`` for a down
        node) — the router twin of :meth:`VideoStore.config`."""
        nodes: dict[str, Optional[dict]] = {}
        for name in sorted(self.addresses):
            with self._lock:
                if name in self._down:
                    nodes[name] = None
                    continue
            try:
                doc = self._channel(name).config()
                nodes[name] = {k: v.to_doc() for k, v in doc.items()}
            except _CONN_ERRORS:
                self._mark_down(name)
                nodes[name] = None
        return {"nodes": nodes}

    # ------------------------------------------------------------- catalog
    def videos(self) -> list[str]:
        return sorted(self.placement.assignments)

    def __contains__(self, name: str) -> bool:
        return name in self.placement.assignments

    def __len__(self) -> int:
        return len(self.placement.assignments)

    def epochs(self, video: str) -> dict[int, int]:
        return self._on_video(video, lambda ch: ch.epochs(video))

    def stats(self) -> dict:
        """Cluster-wide accounting: per-node engine stats (``None`` for a
        down node) plus summed totals and the placement table."""
        nodes: dict[str, Optional[dict]] = {}
        for name in sorted(self.addresses):
            with self._lock:
                if name in self._down:
                    nodes[name] = None
                    continue
            try:
                nodes[name] = self._channel(name).stats()
            except _CONN_ERRORS:
                self._mark_down(name)
                nodes[name] = None
        live = [d for d in nodes.values() if d]
        with self._lock:
            down = sorted(self._down)
        return {
            "videos": self.videos(),
            "replication": self.placement.replication,
            "placement": {v: list(r)
                          for v, r in self.placement.assignments.items()},
            "nodes": nodes,
            "down": down,
            "tiles_decoded_total": sum(d["tiles_decoded_total"]
                                       for d in live),
            "pixels_decoded_total": sum(d["pixels_decoded_total"]
                                        for d in live),
            "storage_bytes": sum(d["storage_bytes"] for d in live),
            "cache": _sum_cache_docs(d.get("cache") or {} for d in live),
        }


# ============================================================== front end
class ClusterRouterServer(VideoStoreServer):
    """The node's socket front end over a :class:`ClusterRouter` — clients
    speak the identical protocol to a cluster or a single node.  Adds
    placement/health introspection ops on top."""

    def _handle(self, op: str, req: dict):
        router: ClusterRouter = self.store
        if op == "ping":
            doc = super()._handle(op, req)
            with router._lock:
                down = sorted(router._down)
            doc.update(cluster=True, nodes=sorted(router.addresses),
                       down=down)
            return doc
        if op == "placement":
            return router.placement.to_doc()
        if op == "node_health":
            return router.ping_nodes()
        if op == "repair":
            return router.repair(video=req.get("video"),
                                 node=req.get("node"))
        if op == "rebalance":
            return router.rebalance(apply=bool(req.get("apply")))
        if op == "repair_status":
            return router.repair_status()
        if op == "drain_repair":
            return router.drain_repair(req.get("timeout"))
        if op == "join_node":
            return router.join_node(req["name"], req["addr"])
        return super()._handle(op, req)


class ClusterClient(RemoteVideoStore):
    """Talk to a :class:`ClusterRouterServer`: the full declarative
    surface of :class:`RemoteVideoStore` (scans, batches, sessions,
    mutations — routed transparently) plus cluster introspection."""

    def placement(self) -> dict:
        return self._call("placement")

    def node_health(self) -> dict:
        """Router-side health probe of every node (revives answerers)."""
        return self._call("node_health")

    def repair(self, video: Optional[str] = None,
               node: Optional[str] = None) -> list:
        """Enqueue background re-replication; returns job descriptors."""
        params: dict = {}
        if video is not None:
            params["video"] = video
        if node is not None:
            params["node"] = node
        return self._call("repair", **params)

    def rebalance(self, apply: bool = False) -> dict:
        return self._call("rebalance", apply=bool(apply))

    def repair_status(self) -> dict:
        return self._call("repair_status")

    def drain_repair(self, timeout: Optional[float] = None) -> dict:
        """Block until every queued copy job finishes (or *timeout*)."""
        dl = None if self._timeout is None else self._timeout + (timeout or 0.0)
        return self._call("drain_repair", timeout=timeout, _deadline=dl)

    def join_node(self, name: str, addr) -> dict:
        """Register a (possibly fresh) node with the router at runtime."""
        return self._call("join_node", name=name, addr=addr)
