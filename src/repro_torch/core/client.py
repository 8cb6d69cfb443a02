"""RemoteVideoStore: the client half of the cross-process serving layer.

Mirrors the :class:`~repro_torch.core.engine.VideoStore` declarative surface
over the ``wire.py`` protocol, so swapping an in-process store for a shared
server is a one-line change::

    store = RemoteVideoStore("/tmp/tasm.sock")          # unix socket
    store = RemoteVideoStore(host="10.0.0.5", port=7841)  # tcp

    res  = store.scan("cam0").labels("car").frames(0, 96).execute()
    plan = store.scan("cam0").labels("car").explain()     # no decode
    results = store.execute_many([q1, q2, q3])            # one merged batch
    with store.serve() as session:                        # concurrent submit
        futs = [session.submit(q) for q in queries]

Every client of one server shares its scheduler, tile cache, and
background tuner: queries from different client *processes* merge into
union-of-tiles decodes and warm each other's cache (the server funnels all
scan RPCs through one shared ``ServingSession``).  Results are
bit-identical to in-process ``execute()`` — region tuples, pixel crops
(npz round-trip preserves dtype/bits), and ScanStats all cross the wire.

Transport: with ``transport="auto"`` (default; ``$REPRO_TORCH_TRANSPORT``
overrides) a unix-socket client negotiates the server's zero-copy
shared-memory reply path — region arrays arrive as read-only numpy views
onto server-written /dev/shm segments instead of bytes copied off the
socket — falling back silently to the npz payload when the server
declines (TCP, ``--transport socket``, no /dev/shm).  ``transport="shm"``
raises if negotiation fails; ``transport="socket"`` never negotiates.
Segment leases are refcounted: each view's garbage collection (or
``close()``) releases its segment back to the server.  Bits are identical
on either transport.

One socket, pipelined: requests carry ids; a reader thread resolves
response frames to their futures, so many in-flight scans share the
connection without head-of-line blocking on the server side (scan replies
are written from future callbacks there).  All public methods are
thread-safe.  Failures of the remote call re-raise locally — common
builtin exception types (KeyError, ValueError, …) are mapped back by name,
anything else surfaces as :class:`RemoteError`.

This client speaks to the port's :class:`~repro_torch.core.server.
VideoStoreServer` and parses the port's config documents.  The frames are
the reference package's, but a reference client cannot parse a port
server's ``config()`` reply (the port's ``DecodeConfig`` carries a
``device`` field, and ``from_doc`` is ``cls(**doc)``), and a port client
parses only port configs: clients of the other package are not a goal.
"""
from __future__ import annotations

import dataclasses
import socket
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Optional

import numpy as np

from repro_torch.core import wire
from repro_torch.core.config import CacheConfig, DecodeConfig, TuningConfig
from repro_torch.core.shm import (attach_segment, resolve_transport,
                                  shm_available)
from repro_torch.core.engine import IngestStats
from repro_torch.core.policies import Policy, policy_spec
from repro_torch.core.query import (PhysicalPlan, ScanPlan, ScanQuery,
                                    ScanResult)
from repro_torch.core.tile_cache import CacheStats
from repro_torch.core.tuner import TunerStats

#: server-raised exception types re-raised as themselves on the client
_ERROR_TYPES = {e.__name__: e for e in
                (KeyError, ValueError, TypeError, RuntimeError,
                 IndexError, NotImplementedError)}

#: ops safe to transparently re-send after a reconnect.  Mutations
#: (ingest/add_detections/retile/…) are NOT here: the server may have
#: applied one before the connection died, and re-sending would double
#: it — those surface the ConnectionError to the caller instead.
_IDEMPOTENT_OPS = frozenset({"ping", "videos", "stats", "explain",
                             "execute_many", "tuner_stats", "epochs",
                             "config", "drain_prefetch"})


def _parse_config_doc(doc: dict) -> dict:
    return {"cache": CacheConfig.from_doc(doc["cache"]),
            "tuning": TuningConfig.from_doc(doc["tuning"]),
            "decode": DecodeConfig.from_doc(doc["decode"])}


class RemoteError(RuntimeError):
    """A server-side failure with no local builtin counterpart."""


class ClientClosed(RuntimeError, wire.ConnectionClosed):
    """A call on a closed client.  Still a ``RuntimeError``, and also a
    ``ConnectionClosed``: a cluster router closes a node's channel when
    any thread marks the node down, so another thread already holding
    that channel must fail over like on any lost connection, not fail
    its read."""


def _raise_remote(err: dict):
    etype, msg = err.get("type", "Error"), err.get("message", "")
    exc = _ERROR_TYPES.get(etype)
    if exc is KeyError:
        # str(KeyError("x")) is "'x'" — unwrap so the message doesn't
        # double-quote on the second raise
        raise KeyError(msg.strip("'\""))
    if exc is not None:
        raise exc(msg)
    raise RemoteError(f"{etype}: {msg}")


class RemoteScanQuery(ScanQuery):
    """The chainable builder, executing over the wire.  ``_clone`` keeps
    the subclass, so forked partial queries stay remote."""

    def explain(self) -> PhysicalPlan:
        return self._engine._explain(self.plan())

    def execute(self) -> ScanResult:
        return self._engine.execute(self.plan())

    def submit(self) -> Future:
        """Fire-and-collect: returns a Future resolving to the
        :class:`ScanResult` (the remote twin of session submission)."""
        return self._engine._submit_plan(self.plan())


class RemoteServingSession:
    """Client-side ``serve()`` session: ``submit`` returns a Future.

    There is no client-side batching to coordinate — every submission goes
    straight onto the shared connection and the SERVER micro-batches
    everything queued across all clients, which is exactly what makes
    cross-process merging work.  ``close`` waits for this session's
    outstanding futures."""

    def __init__(self, store: "RemoteVideoStore"):
        self._store = store
        self._futs: list[Future] = []
        self._lock = threading.Lock()
        self._closed = False

    def submit(self, query) -> Future:
        with self._lock:
            if self._closed:
                raise RuntimeError("serving session is closed")
            fut = self._store._submit_plan(self._store._as_plan(query))
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

    def __enter__(self) -> "RemoteServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _SegmentLease:
    """One reply's shared-memory segment on the client side.

    Each top-level array built on the mapping registers a finalizer that
    derefs this lease; numpy's base-chain keeps a top-level array alive as
    long as any derived view of it exists, so the last deref really is the
    last reader.  ``deref`` runs in GC context — it may fire on ANY thread
    at ANY allocation, including while that thread holds the client's
    locks — so it must be lock-free: it only moves the lease onto the
    owning client's release deque (GIL-atomic append).  The client's
    janitor thread does the actual unmapping and the ``shm_release`` RPC."""

    __slots__ = ("name", "seg", "_tokens", "_done_buf")

    def __init__(self, name: str, seg, n_arrays: int, done_buf):
        self.name = name
        self.seg = seg
        self._tokens = [None] * n_arrays
        self._done_buf = done_buf

    def deref(self) -> None:
        try:
            self._tokens.pop()
        except IndexError:  # pragma: no cover - duplicate final deref
            return
        if not self._tokens:
            # racing final derefs may BOTH land here (pop then observe
            # empty) — the janitor dedupes by name, so that's harmless
            self._done_buf.append(self)


class RemoteVideoStore:
    """Connect to a :class:`~repro_torch.core.server.VideoStoreServer`."""

    def __init__(self, path: Optional[str] = None, *,
                 host: Optional[str] = None, port: Optional[int] = None,
                 timeout: Optional[float] = None,
                 codec: Optional[str] = None,
                 max_frame_bytes: int = wire.DEFAULT_MAX_FRAME_BYTES,
                 want_plans: bool = True,
                 transport: Optional[str] = None,
                 retries: int = 0, retry_backoff: float = 0.05):
        """``retries`` > 0 turns on reconnect-with-retry for *idempotent*
        RPCs (scans, explain, stats, …): a ConnectionError tears the
        socket down, redials, and re-sends, backing off
        ``retry_backoff * attempt`` seconds between tries.  Mutations
        never retry — the server may have applied one before the
        connection died — so they surface the error.  The default 0
        keeps the legacy fail-fast behaviour.

        ``timeout`` is the connect timeout AND the per-RPC deadline: a
        call whose reply hasn't arrived within ``timeout`` seconds severs
        the connection and raises ``ConnectionClosed`` — a hung (not
        dead) node fails fast instead of blocking the calling thread
        forever, so a router can fail over.  ``None`` (default) waits
        indefinitely.  RPCs that legitimately block server-side
        (``drain_tuner(timeout=t)``) extend the deadline by their own
        wait."""
        if (path is None) == (host is None):
            raise ValueError("give exactly one of path= (unix socket) or "
                             "host=/port= (tcp)")
        if host is not None and port is None:
            raise ValueError("host= needs port= (tcp)")
        self.codec = codec
        self.max_frame_bytes = int(max_frame_bytes)
        self.want_plans = bool(want_plans)
        self.transport_mode = resolve_transport(transport)
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        self._path, self._host, self._port = path, host, port
        self._timeout = timeout
        self._send_lock = threading.Lock()
        self._pending: dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        self._next_id = 0
        self._closed = False
        self._last_ingest_epochs: dict[int, int] = {}
        self._leases: dict[str, _SegmentLease] = {}
        self._lease_lock = threading.Lock()
        # leases whose last view was GC'd, appended lock-free by
        # finalizers; drained (unmap + release RPC) by the janitor thread
        self._done_leases: deque = deque()
        self._janitor: Optional[threading.Thread] = None
        self._janitor_stop = threading.Event()
        self._transport = "npz"
        self._sock = self._connect()
        self._reader = self._start_reader()
        try:
            self._transport = self._negotiate_transport()
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ plumbing
    def _connect(self) -> socket.socket:
        if self._path is not None:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self._timeout)
            sock.connect(self._path)
        else:
            sock = socket.create_connection((self._host, self._port),
                                            timeout=self._timeout)
        # the socket itself stays blocking after connect: a recv timeout
        # would fire in the reader thread during any idle gap and poison
        # the connection.  The per-RPC deadline is enforced in _result()
        # instead — only calls with an outstanding reply are on the clock
        sock.settimeout(None)
        return sock

    def _start_reader(self) -> threading.Thread:
        t = threading.Thread(target=self._read_loop, args=(self._sock,),
                             name="tasm-client-reader", daemon=True)
        t.start()
        return t

    def _reconnect(self) -> None:
        """Tear down the dead connection and dial a fresh one.  Futures
        pending on the old connection were already failed by its reader's
        death sweep (joined here, so the sweep can't race the reset);
        requests sent afterwards ride the new socket."""
        with self._send_lock:
            if self._closed:
                raise ClientClosed("remote store is closed")
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._reader.join(timeout=5)
            self._sock = self._connect()  # may raise: _dead stays set
            with self._pending_lock:
                self._dead = None
            self._reader = self._start_reader()
        # leases from the old connection are already server-reclaimed (its
        # drop sweep); our mappings stay valid (POSIX unlink semantics) and
        # their finalizer releases turn into ignored unknown-name RPCs.
        # Negotiation is a normal RPC, so it must run OUTSIDE _send_lock.
        self._transport = self._negotiate_transport()

    # ---------------------------------------------------------- transport
    @property
    def transport(self) -> str:
        """What this connection's scan replies ride: ``"shm"`` or
        ``"npz"``."""
        return self._transport

    def _negotiate_transport(self) -> str:
        """Probe for the zero-copy reply path: attach the server's nonce
        segment, read the nonce back, and echo it through ``shm_enable`` —
        proof that both sides map the SAME /dev/shm (a remote peer, or a
        container with a private shm namespace, fails the readback and
        stays on npz).  ``transport="shm"`` escalates any failure;
        ``"auto"`` falls back silently; ``"socket"`` never probes."""
        mode = self.transport_mode
        if mode == "socket":
            return "npz"
        if mode == "auto" and (self._path is None or not shm_available()):
            return "npz"  # TCP peers don't share a host; don't even probe
        try:
            probe = self._result(self._request("shm_probe"), "shm_probe")
            if not probe.get("enabled"):
                raise RuntimeError(
                    "server declines shared-memory transport")
            seg = attach_segment(probe["segment"])
            try:
                nonce = bytes(seg.buf[:int(probe["nbytes"])]).hex()
            finally:
                seg.close()
            if not self._result(
                    self._request("shm_enable", segment=probe["segment"],
                                  nonce=nonce), "shm_enable"):
                raise RuntimeError("shared-memory nonce verification "
                                   "failed")
            return "shm"
        except Exception as e:  # noqa: BLE001 - fallback is the contract
            if mode == "shm":
                raise RuntimeError(
                    f"transport='shm' unavailable: {e}") from e
            return "npz"

    def _shm_read(self, shm_doc: dict) -> list:
        """``wire`` shm reader: map the reply's segment and build
        read-only array views onto it (zero copies).  Runs on the reader
        thread, so a bad descriptor poisons only this connection."""
        name = str(shm_doc["seg"])
        items = shm_doc.get("items") or []
        seg = attach_segment(name)
        if not items:  # degenerate: no arrays — nothing to hold the lease
            seg.close()
            self._release_segments([name])
            return []
        lease = _SegmentLease(name, seg, len(items), self._done_leases)
        views = []
        for off, shape, dtype in items:
            shape = tuple(int(s) for s in shape)
            count = 1
            for s in shape:
                count *= s
            a = np.frombuffer(seg.buf, dtype=np.dtype(str(dtype)),
                              count=count, offset=int(off))
            a.flags.writeable = False
            a = a.reshape(shape)
            weakref.finalize(a, lease.deref)
            views.append(a)
        with self._lease_lock:
            self._leases[name] = lease
            if self._janitor is None:
                self._janitor = threading.Thread(
                    target=self._janitor_loop,
                    name="tasm-client-janitor", daemon=True)
                self._janitor.start()
        return views

    def _janitor_loop(self) -> None:
        """Drain GC'd leases every 50 ms: unmap the segment and tell the
        server to unlink it.  A dedicated thread because finalizers must
        not unmap or RPC themselves — they fire mid-allocation on
        arbitrary threads, possibly while THAT thread holds the very
        locks the release path needs."""
        while not self._janitor_stop.wait(0.05):
            self._drain_done_leases()
        self._drain_done_leases()

    def _drain_done_leases(self) -> None:
        names = []
        seen = set()
        while True:
            try:
                lease = self._done_leases.popleft()
            except IndexError:
                break
            if lease.name in seen:  # racing final derefs may duplicate
                continue
            seen.add(lease.name)
            try:
                lease.seg.close()
            except BufferError:  # pragma: no cover - dealloc mid-flight
                self._done_leases.append(lease)  # retry next tick
                continue
            names.append(lease.name)
        if names:
            self._release_segments(names)

    def _release_segments(self, names: list) -> None:
        """Fire-and-forget lease release (a redundant release of an
        already-reclaimed name is ignored by the server).  Connection
        failures are swallowed — a dead connection's leases are reclaimed
        by the server's drop sweep."""
        with self._lease_lock:
            for n in names:
                self._leases.pop(n, None)
        try:
            self._request("shm_release", segments=list(names))
        except BaseException:  # noqa: BLE001 - best effort
            pass

    def _flush_leases(self) -> None:
        """Release every outstanding lease and wait briefly for the
        server to acknowledge — close() calls this BEFORE the socket goes
        down so a well-behaved exit leaves zero segments behind even if
        this process never runs another GC."""
        self._drain_done_leases()
        with self._lease_lock:
            names, self._leases = list(self._leases), {}
        if not names:
            return
        try:
            self._request("shm_release", segments=names).result(timeout=5)
        except BaseException:  # noqa: BLE001 - server sweep covers us
            pass

    def _with_retry(self, fn):
        """Run ``fn`` (which must be safe to repeat), reconnecting and
        re-trying on connection-level failures up to ``self.retries``
        times with linear backoff."""
        attempt = 0
        while True:
            try:
                return fn()
            except (wire.ConnectionClosed, wire.WireError, OSError):
                attempt += 1
                if attempt > self.retries:
                    raise
                time.sleep(self.retry_backoff * attempt)
                try:
                    self._reconnect()
                except OSError:
                    pass  # still down: next attempt fails fast, re-counts

    def _read_loop(self, sock: socket.socket) -> None:
        err: BaseException
        try:
            while True:
                resp = wire.read_frame(sock,
                                       max_bytes=self.max_frame_bytes,
                                       shm_reader=self._shm_read)
                rid = resp.get("id")
                with self._pending_lock:
                    fut = self._pending.pop(rid, None)
                if fut is not None:
                    if resp.get("ok"):
                        fut.set_result(resp.get("value"))
                    else:
                        try:
                            _raise_remote(resp.get("error") or {})
                        except BaseException as e:  # noqa: BLE001
                            fut.set_exception(e)
                # clear the loop locals NOW: left bound while blocked in
                # recv they would pin the reply's arrays (and their shm
                # leases) until the next frame happens to arrive
                fut = resp = None
        except BaseException as e:  # noqa: BLE001 - fail all pending
            err = e
        if isinstance(err, wire.ConnectionClosed):
            err = wire.ConnectionClosed("server closed the connection")
        with self._pending_lock:
            # _dead is set under the same lock that registers futures, so
            # a request can never slip into _pending after this sweep and
            # hang unresolved forever
            self._dead = err
            pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            fut.set_exception(err)

    def _request(self, op: str, **params) -> Future:
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        with self._send_lock:
            if self._closed:
                raise ClientClosed("remote store is closed")
            rid = self._next_id
            self._next_id += 1
            with self._pending_lock:
                if self._dead is not None:
                    # reader thread is gone — a write might still land in
                    # the OS buffer, but nothing will ever resolve the
                    # future: fail fast instead
                    raise wire.ConnectionClosed(
                        f"connection lost: {self._dead}")
                self._pending[rid] = fut
            try:
                wire.write_frame(self._sock, {"id": rid, "op": op, **params},
                                 codec=self.codec,
                                 max_bytes=self.max_frame_bytes)
            except BaseException:
                with self._pending_lock:
                    self._pending.pop(rid, None)
                raise
        return fut

    def _result(self, fut: Future, op: str, deadline=...):
        """Wait for an RPC reply, enforcing the per-RPC deadline.  A hung
        (not dead) node never replies and never drops the socket; without
        a deadline that blocks the calling thread — a router serving
        thread — forever.  On expiry the connection is severed (failing
        every pipelined call on it, exactly as if the node died) and
        ``ConnectionClosed`` surfaces so retry/failover machinery treats
        the node as down."""
        if deadline is ...:
            deadline = self._timeout
        if deadline is None:
            return fut.result()
        try:
            return fut.result(timeout=deadline)
        except _FutTimeout:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise wire.ConnectionClosed(
                f"RPC {op!r} exceeded the {deadline}s deadline "
                f"(node hung?)") from None

    def _call(self, op: str, _deadline=..., **params):
        if self.retries and op in _IDEMPOTENT_OPS:
            return self._with_retry(
                lambda: self._result(self._request(op, **params), op,
                                     _deadline))
        return self._result(self._request(op, **params), op, _deadline)

    def close(self) -> None:
        with self._send_lock:
            if self._closed:
                return
        # release outstanding shm leases over the still-open connection
        # (idempotent if two closers race — the server ignores unknown
        # names); must precede _closed, which _request refuses
        self._flush_leases()
        with self._send_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=5)
        self._janitor_stop.set()
        if self._janitor is not None:
            self._janitor.join(timeout=5)

    def __enter__(self) -> "RemoteVideoStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- admin
    def ping(self) -> dict:
        return self._call("ping")

    def videos(self) -> list[str]:
        return self._call("videos")

    def __contains__(self, name: str) -> bool:
        return name in self.videos()

    def stats(self) -> dict:
        return self._call("stats")

    def epochs(self, video: str) -> dict[int, int]:
        """``{sot_id: layout epoch}`` on the server — the remote twin of
        :meth:`VideoStore.epochs` (replica consistency checks)."""
        return {int(s): int(e)
                for s, e in self._call("epochs", video=video)}

    @property
    def last_ingest_epochs(self) -> dict[int, int]:
        """Epoch table acknowledged by this client's most recent
        ``ingest`` (empty before any ingest)."""
        return dict(self._last_ingest_epochs)

    def shutdown_server(self) -> None:
        """Ask the server to stop (it replies, then shuts down)."""
        self._call("shutdown")

    @staticmethod
    def _video_kw_doc(encoder=None, policy=None, cost_model=None,
                      sot_len=None) -> dict:
        doc: dict = {}
        if encoder is not None:
            doc["encoder"] = dataclasses.asdict(encoder)
        if policy is not None:
            doc["policy"] = policy_spec(policy) \
                if isinstance(policy, Policy) else policy
        if cost_model is not None:
            doc["cost_model"] = {
                "beta": cost_model.beta, "gamma": cost_model.gamma,
                "r_squared": cost_model.r_squared,
                "io_per_pixel": cost_model.io_per_pixel,
                "encode_per_pixel": cost_model.encode_per_pixel,
                "encode_per_tile": cost_model.encode_per_tile}
        if sot_len is not None:
            doc["sot_len"] = int(sot_len)
        return doc

    def add_video(self, name: str, *, encoder=None, policy=None,
                  cost_model=None, sot_len=None) -> None:
        self._call("add_video", name=name,
                   **self._video_kw_doc(encoder, policy, cost_model,
                                        sot_len))

    def ingest(self, name: str, frames: np.ndarray, *, detections=None,
               initial_layouts=None, **video_kw) -> IngestStats:
        doc = self._call(
            "ingest", name=name, frames=np.ascontiguousarray(frames),
            detections=None if detections is None
            else [[[label, list(bbox)] for label, bbox in frame_dets]
                  for frame_dets in detections],
            initial_layouts=None if initial_layouts is None
            else [[int(s), list(lay.heights), list(lay.widths)]
                  for s, lay in initial_layouts.items()],
            **self._video_kw_doc(**video_kw))
        doc = dict(doc)
        # replica-aware ack: the server's post-ingest epoch table, kept
        # for callers (the cluster router) that verify replicas landed on
        # the same physical generation
        self._last_ingest_epochs = {
            int(s): int(e) for s, e in doc.pop("epochs", None) or []}
        return IngestStats(**doc)

    def add_detections(self, video: str, detections_by_frame: dict) -> None:
        self._call("add_detections", video=video,
                   pairs=[[int(f), [[label, list(bbox)]
                                    for label, bbox in dets]]
                          for f, dets in
                          sorted(detections_by_frame.items())])

    def add_metadata(self, video: str, frame: int, label: str,
                     x1: int, y1: int, x2: int, y2: int) -> None:
        self._call("add_metadata", video=video, frame=int(frame),
                   label=label, x1=int(x1), y1=int(y1), x2=int(x2),
                   y2=int(y2))

    # ---------------------------------------------------------------- scan
    def scan(self, videos, labels=None,
             frames: Optional[tuple[int, int]] = None) -> RemoteScanQuery:
        q = RemoteScanQuery(self, videos)
        if labels is not None:
            q = q.labels(labels)
        if frames is not None:
            q = q.frames(*frames)
        return q

    @staticmethod
    def _as_plan(query) -> ScanPlan:
        if isinstance(query, ScanQuery):
            return query.plan()
        if isinstance(query, ScanPlan):
            return query
        raise TypeError(f"cannot execute {type(query).__name__} remotely; "
                        "want ScanQuery or ScanPlan")

    def _submit_plan(self, plan: ScanPlan) -> Future:
        raw = self._request("scan", plan=plan.to_doc(),
                            want_plan=self.want_plans)
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        raw.add_done_callback(lambda f: _chain_result(
            f, fut, ScanResult.from_doc))
        return fut

    def execute(self, query) -> ScanResult:
        """Execute one scan (accepts a ScanQuery or logical ScanPlan).
        Scans are idempotent, so with ``retries`` set a dropped
        connection redials and re-sends; async ``submit()`` futures stay
        fail-fast (the caller owns their lifecycle)."""
        plan = self._as_plan(query)
        if self.retries:
            return self._with_retry(
                lambda: self._result(self._submit_plan(plan), "scan"))
        return self._result(self._submit_plan(plan), "scan")

    def execute_many(self, queries) -> list[ScanResult]:
        """One merged batch on the server (union-of-tiles decode across the
        batch), results in submission order — the remote twin of
        ``VideoStore.execute_many``."""
        docs = self._call(
            "execute_many",
            plans=[self._as_plan(q).to_doc() for q in queries],
            want_plan=self.want_plans)
        return [ScanResult.from_doc(d) for d in docs]

    def _explain(self, plan: ScanPlan) -> PhysicalPlan:
        return PhysicalPlan.from_doc(self._call("explain",
                                                plan=plan.to_doc()))

    def serve(self) -> RemoteServingSession:
        """Open a concurrent-submission session (server-side
        micro-batching merges across every client's in-flight scans)."""
        return RemoteServingSession(self)

    # -------------------------------------------------------------- tuning
    def retile(self, video: str, sot_id: int, new_layout) -> float:
        return self._call("retile", video=video, sot_id=int(sot_id),
                          heights=list(new_layout.heights),
                          widths=list(new_layout.widths))

    def drain_tuner(self, timeout: Optional[float] = None) -> TunerStats:
        # the server legitimately blocks for up to `timeout` before
        # replying — extend the per-RPC deadline by that wait
        dl = ... if self._timeout is None \
            else self._timeout + (timeout or 0.0)
        return TunerStats(**self._call("drain_tuner", timeout=timeout,
                                       _deadline=dl))

    def tuner_stats(self) -> TunerStats:
        return TunerStats(**self._call("tuner_stats"))

    def drain_prefetch(self, timeout: Optional[float] = None) -> CacheStats:
        """Remote twin of :meth:`VideoStore.drain_prefetch` — block until
        the server's predictive decodes land, return its cache stats."""
        dl = ... if self._timeout is None \
            else self._timeout + (timeout or 0.0)
        return CacheStats(**self._call("drain_prefetch", timeout=timeout,
                                       _deadline=dl))

    def config(self) -> dict:
        """The server's resolved runtime configuration as config objects:
        ``{"cache": CacheConfig, "tuning": TuningConfig,
        "decode": DecodeConfig}`` — the exact surface the server was
        started with (see ``core/config.py``).  Against a cluster router
        the reply is per node: ``{"nodes": {name: {...}|None}}``."""
        doc = self._call("config")
        if "nodes" in doc:      # router front end: one config set per node
            return {"nodes": {name: None if d is None
                              else _parse_config_doc(d)
                              for name, d in doc["nodes"].items()}}
        return _parse_config_doc(doc)

    # ----------------------------------------------------- replica streaming
    # The cluster repair data plane: each chunk is one request/reply RPC,
    # so copies are resumable at chunk granularity.  Called by the repair
    # worker (core/repair.py), not by applications.
    def export_meta(self, video: str) -> dict:
        """The source video's manifest doc (incl. its SOT epoch table)."""
        return self._call("export_meta", video=video)

    def export_chunk(self, video: str, sot_id: int, tile_idx: int) -> dict:
        """One encoded tile stream with its content checksum, stamped with
        the epoch it was read at (the caller re-streams on a mismatch)."""
        return self._call("export_chunk", video=video, sot_id=int(sot_id),
                          tile_idx=int(tile_idx))

    def import_begin(self, video: str) -> dict:
        """Open or resume the destination's staging namespace; returns
        the chunks already staged intact."""
        return self._call("import_begin", video=video)

    def import_chunk(self, video: str, sot_id: int, epoch: int,
                     tile_idx: int, enc: dict, checksum: str) -> None:
        """Stage one chunk (checksum re-verified server-side)."""
        self._call("import_chunk", video=video, sot_id=int(sot_id),
                   epoch=int(epoch), tile_idx=int(tile_idx), enc=enc,
                   checksum=checksum)

    def import_commit(self, video: str, doc: dict,
                      min_epochs: Optional[dict] = None) -> dict:
        """Atomically flip the staged copy live (after epoch-table and
        per-tile checksum verification)."""
        return self._call(
            "import_commit", video=video, doc=doc,
            min_epochs=[[int(s), int(e)]
                        for s, e in sorted((min_epochs or {}).items())])

    def import_abort(self, video: str) -> None:
        self._call("import_abort", video=video)


def _chain_result(src: Future, dst: Future, decode) -> None:
    try:
        dst.set_result(decode(src.result()))
    except BaseException as e:  # noqa: BLE001 - surfaced via the future
        dst.set_exception(e)
