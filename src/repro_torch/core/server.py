"""VideoStoreServer: the cross-process serving front end.

TASM's wins live in shared physical state — one tuned tile layout, one
decoded-tile cache, one background tuner.  Before this module only threads
inside a single Python process could share them; every external client
re-decoded and re-tuned from cold.  ``VideoStoreServer`` draws the same
system boundary VSS puts between its storage server and analytics clients:
it owns ONE :class:`~repro_torch.core.engine.VideoStore` and accepts concurrent
client connections over a Unix-domain or TCP socket speaking the
length-prefixed frames of ``wire.py``.

Cross-client merging: every scan RPC — from any connection — is submitted
to one shared :class:`~repro_torch.core.scheduler.ServingSession`, whose
dispatcher micro-batches whatever is queued into a single ``execute_many``
call.  Scans from different client *processes* hitting the same
``(video, sot_id, epoch)`` therefore merge into one union-of-tiles decode
and share tile-cache entries, exactly like threads of one process: the
second client's repeat of a scan the first client already ran decodes zero
tiles.  The scheduler's serial-equivalence invariant makes every remote
result bit-identical to an in-process ``execute()`` of the same plan.

Protocol: request frames are ``{"id": n, "op": name, ...params}``;
responses ``{"id": n, "ok": True, "value": ...}`` or ``{"id": n, "ok":
False, "error": {"type", "message"}}``.  Ids multiplex one connection —
scan responses are written from future callbacks, so a client can pipeline
requests and a slow decode never blocks its neighbour's ping.  A malformed
or oversized frame gets an error frame (id ``None``) and closes only that
connection; the server — and every other client — keeps running.

Durable mutations (``ingest``/``add_detections``/``retile``/…) run inline
on the connection thread through the engine's own locking, so they
serialize against scans the same way in-process callers do.

Zero-copy transport: scan replies to same-host clients ride a
shared-memory :class:`~repro_torch.core.shm.SegmentPool` — the reply's region
arrays are written once into a leased segment and only ``(segment,
offset, shape, dtype)`` descriptors cross the socket (``transport="shm"``,
negotiated per connection via a nonce probe that proves /dev/shm is
genuinely shared).  Remote/TCP peers, declined probes, and pool overflow
fall back to the npz payload automatically.  Reply *marshalling* (doc
building + payload packing) runs on the scheduler's worker pool, not the
serving session's dispatcher thread, so replies to many clients encode in
parallel on either transport.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import queue
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import wire
from repro_torch.core.cost import CostModel
from repro_torch.core.engine import VideoStore
from repro_torch.core.layout import TileLayout
from repro_torch.core.policies import policy_from_spec
from repro_torch.core.query import ScanPlan
from repro_torch.core.shm import (SegmentPool, resolve_transport,
                                  shm_available, DEFAULT_POOL_BYTES)


def _cost_model_from_doc(doc: Optional[dict]) -> Optional[CostModel]:
    if doc is None:
        return None
    cm = CostModel(beta=doc["beta"], gamma=doc["gamma"],
                   r_squared=doc.get("r_squared", 0.0))
    if doc.get("io_per_pixel") is not None:
        cm.io_per_pixel = doc["io_per_pixel"]
    if doc.get("encode_per_pixel") is not None:
        cm.encode_per_pixel = doc["encode_per_pixel"]
    if doc.get("encode_per_tile") is not None:
        cm.encode_per_tile = doc["encode_per_tile"]
    return cm


def _video_kw_from_doc(doc: dict) -> dict:
    """Decode the add_video/ingest per-video kwargs (encoder dict, policy
    spec, cost-model params, sot_len) into engine objects."""
    kw = {}
    if doc.get("encoder") is not None:
        kw["encoder"] = EncoderConfig(**doc["encoder"])
    if doc.get("policy") is not None:
        kw["policy"] = policy_from_spec(doc["policy"])
    if doc.get("cost_model") is not None:
        kw["cost_model"] = _cost_model_from_doc(doc["cost_model"])
    if doc.get("sot_len") is not None:
        kw["sot_len"] = int(doc["sot_len"])
    return kw


def _detections_from_doc(pairs) -> dict:
    return {int(f): [(label, tuple(int(c) for c in bbox))
                     for label, bbox in dets]
            for f, dets in pairs}


class _ConnState:
    """Per-connection serving state: the socket, its bounded reply queue,
    and the shared-memory lease identity.  The state object itself is the
    ``owner`` token segments are leased under, so reclaiming a dead
    connection's segments is an identity lookup, not bookkeeping."""

    __slots__ = ("sock", "outq", "shm", "closed")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # responses go through a bounded per-connection queue drained by a
        # writer thread: scan replies arrive from marshalling workers, and
        # a blocking sendall to ONE stalled client there would wedge every
        # other client's replies.  A full queue means the client stopped
        # reading — drop it.
        self.outq: queue.Queue = queue.Queue(maxsize=256)
        self.shm = False      # negotiated: replies may ride shared memory
        self.closed = False   # teardown begun: release, don't lease


class VideoStoreServer:
    """Serve one :class:`VideoStore` to many client processes.

    Exactly one of ``path`` (Unix-domain socket) or ``host`` (TCP; pass
    ``port=0`` for an ephemeral port, read it back from :attr:`address`)
    must be given.  Use as a context manager, or ``start()`` /
    ``stop()`` explicitly; :meth:`serve_forever` blocks until
    :meth:`stop` (e.g. from a signal handler) is called.

    ``transport`` — ``"auto"`` (default; ``$REPRO_TORCH_TRANSPORT``
    overrides) offers the shared-memory reply path to clients that prove
    they share /dev/shm, ``"shm"`` requires it (``start()`` raises when
    unavailable), ``"socket"`` disables it (every reply rides the npz
    payload).

    ``owns_store=True`` (default) closes the store on ``stop()``.
    """

    def __init__(self, store: VideoStore, *,
                 path: Optional[str] = None,
                 host: Optional[str] = None, port: int = 0,
                 max_frame_bytes: int = wire.DEFAULT_MAX_FRAME_BYTES,
                 codec: Optional[str] = None,
                 max_batch: int = 64,
                 transport: Optional[str] = None,
                 shm_max_bytes: int = DEFAULT_POOL_BYTES,
                 owns_store: bool = True):
        if (path is None) == (host is None):
            raise ValueError("give exactly one of path= (unix socket) or "
                             "host= (tcp)")
        self.store = store
        self.path = path
        self.host, self.port = host, port
        self.max_frame_bytes = int(max_frame_bytes)
        self.codec = codec  # None = wire.default_codec()
        self.max_batch = max_batch
        self.transport = resolve_transport(transport)
        self.shm_max_bytes = int(shm_max_bytes)
        self.owns_store = owns_store
        self._listener: Optional[socket.socket] = None
        self._session = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: dict[socket.socket, _ConnState] = {}
        self._conn_lock = threading.Lock()
        self._shm_pool: Optional[SegmentPool] = None
        self._marshal_pool: Optional[ThreadPoolExecutor] = None
        self._marshal_lock = threading.Lock()
        self._stopped = threading.Event()
        self._cleanup_done = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopper: Optional[threading.Thread] = None
        self._started = False

    # ---------------------------------------------------------- lifecycle
    @property
    def address(self):
        """Bound address: the socket path, or ``(host, port)`` for TCP."""
        if self.path is not None:
            return self.path
        assert self._listener is not None, "server not started"
        return self._listener.getsockname()[:2]

    def start(self) -> "VideoStoreServer":
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        if self.transport != "socket":
            # probe BEFORE binding so a refusal leaves no socket file
            if shm_available():
                self._shm_pool = SegmentPool(max_bytes=self.shm_max_bytes)
            elif self.transport == "shm":
                raise RuntimeError("transport='shm' but shared memory is "
                                   "unavailable on this host")
        if self.path is not None:
            p = pathlib.Path(self.path)
            if p.exists() and p.is_socket():
                # recover a STALE socket (unclean previous shutdown) but
                # refuse to hijack a live server's address: probe first
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                probe.settimeout(1.0)
                try:
                    probe.connect(self.path)
                except OSError:
                    p.unlink()  # nobody answering: genuinely stale
                else:
                    raise OSError(
                        f"{self.path} is in use by a live server")
                finally:
                    probe.close()
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(self.path)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.host, self.port))
        sock.listen(64)
        self._listener = sock
        self._session = self.store.serve(max_batch=self.max_batch)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tasm-server-accept", daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        """Block until :meth:`stop` has COMPLETED (not merely started):
        the shutdown RPC runs ``stop`` on a daemon thread, so returning on
        the stop *signal* would let the interpreter exit mid-cleanup —
        before the session drained, the store flushed, and the socket file
        was unlinked."""
        self._stopped.wait()
        self._cleanup_done.wait()

    def stop(self) -> None:
        """Stop accepting, close every connection, drain the shared serving
        session, and (when ``owns_store``) close the store.  Idempotent;
        concurrent callers block until the first caller's cleanup is
        done."""
        with self._stop_lock:
            already = self._stopped.is_set()
            if not already:
                self._stopped.set()
                self._stopper = threading.current_thread()
        if already:
            if self._stopper is threading.current_thread():
                # re-entrant: a second SIGTERM/SIGINT interrupted the
                # first handler's cleanup on this very thread — waiting
                # here would deadlock (only the interrupted outer frame
                # can finish the cleanup)
                return
            self._cleanup_done.wait()
            return
        if self._listener is not None:
            # closing a listener does NOT wake a thread blocked in
            # accept(); poke it with a throwaway connection so the accept
            # loop observes _stopped and exits promptly
            try:
                if self.path is not None:
                    poke = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    poke.settimeout(1.0)
                    poke.connect(self.path)
                else:
                    poke = socket.create_connection(
                        self._listener.getsockname()[:2], timeout=1.0)
                poke.close()
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:  # pragma: no cover - already closed
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:  # pragma: no cover - already closed
                pass
        if self._session is not None:
            self._session.close()
        # only unlink a socket WE bound: a failed start() (e.g. the path
        # belongs to a live server) must not tear down someone else's
        if self.path is not None and self._listener is not None:
            try:
                pathlib.Path(self.path).unlink()
            except OSError:
                pass
        with self._marshal_lock:
            pool, self._marshal_pool = self._marshal_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self._shm_pool is not None:
            # after the session drained and marshal workers finished: no
            # new segments can be written, outstanding ones unlink here
            # (clients still mapping them keep valid pages)
            self._shm_pool.close()
        if self.owns_store:
            self.store.close()
        self._cleanup_done.set()

    def __enter__(self) -> "VideoStoreServer":
        return self.start() if not self._started else self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------- connections
    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:  # listener closed by stop()
                return
            st = _ConnState(conn)
            with self._conn_lock:
                self._conns[conn] = st
            threading.Thread(target=self._serve_conn, args=(st,),
                             name="tasm-server-conn", daemon=True).start()

    def _serve_conn(self, st: _ConnState) -> None:
        conn = st.sock
        writer = threading.Thread(target=self._write_loop, args=(st,),
                                  name="tasm-server-write", daemon=True)
        writer.start()
        try:
            while not self._stopped.is_set():
                try:
                    req = wire.read_frame(conn,
                                          max_bytes=self.max_frame_bytes)
                except wire.ConnectionClosed:
                    return
                except wire.WireError as e:
                    # reply with an error frame instead of dying; the
                    # stream may be mid-garbage, so close THIS connection
                    self._send(st, wire.error_doc(None, e))
                    return
                self._dispatch(st, req)
        except OSError:
            return  # connection torn down under us (client gone / stop())
        finally:
            st.closed = True  # before release: a marshal job that leases
            #                   past this point sees the flag and releases
            st.outq.put(None)  # writer drains what's queued, then exits
            with self._conn_lock:
                self._conns.pop(conn, None)
                live = list(self._conns.values())
            if self._shm_pool is not None:
                # reclaim every lease the peer (cleanly closed, crashed,
                # or SIGKILLed alike) left behind, then sweep for strays
                # orphaned by earlier teardown races
                self._shm_pool.release_owner(st)
                self._shm_pool.sweep(live)

    def _write_loop(self, st: _ConnState) -> None:
        """Single writer per connection; only this thread (and only this
        connection) blocks when the peer stops reading."""
        broken = False
        while True:
            payload = st.outq.get()
            if payload is None:
                break
            if isinstance(payload, threading.Event):
                payload.set()  # flush marker: everything before it went out
                continue
            if broken:
                continue  # discard until the sentinel
            try:
                st.sock.sendall(wire._HEADER.pack(len(payload)) + payload)
            except OSError:
                broken = True
        try:
            st.sock.close()
        except OSError:
            pass

    def _segment_writer(self, st: _ConnState, leased: list):
        """Per-reply shared-memory writer for ``wire.dumps``, or ``None``
        when this connection's replies ride the npz payload.  Segment
        names written are recorded in ``leased`` so the caller can release
        them if the reply never reaches the client."""
        if self._shm_pool is None or not st.shm or st.closed:
            return None

        def write(arrays):
            doc = self._shm_pool.write(arrays, owner=st)
            if doc is not None:
                leased.append(doc["seg"])
            return doc

        return write

    @staticmethod
    def _stamp_marshalling(clean: dict, stats_objs: list,
                           transport: str, nbytes: int,
                           marshal_s: float) -> None:
        """Stamp marshalling accounting into the outgoing reply doc AND
        the live ScanStats objects (already appended to engine history by
        the scheduler), so `store.stats()` and the client's result agree.
        A multi-result reply (execute_many) splits cost evenly — the wire
        packs all its arrays as one payload, so per-result attribution
        finer than an even split would be fiction."""
        value = clean.get("value")
        docs = [value] if isinstance(value, dict) else \
            value if isinstance(value, list) else []
        share_s = marshal_s / max(len(stats_objs), 1)
        share_b = nbytes / max(len(stats_objs), 1)
        for stats, doc in zip(stats_objs, docs):
            stats.marshal_s = share_s
            stats.payload_bytes = share_b
            stats.transport = transport
            sdoc = doc.get("stats") if isinstance(doc, dict) else None
            if isinstance(sdoc, dict):
                sdoc["marshal_s"] = share_s
                sdoc["payload_bytes"] = share_b
                sdoc["transport"] = transport

    def _send(self, st: _ConnState, doc: dict,
              stats: Optional[list] = None) -> None:
        """Encode and enqueue one reply.  ``stats`` — the reply's live
        ScanStats objects — turns on marshalling accounting and makes the
        reply eligible for the shared-memory transport."""
        t0 = time.perf_counter()
        leased: list = []
        on_payload = None
        if stats:
            def on_payload(clean, transport, nbytes):
                self._stamp_marshalling(clean, stats, transport, nbytes,
                                        time.perf_counter() - t0)
        try:
            payload = wire.dumps(
                doc, codec=self.codec, max_bytes=self.max_frame_bytes,
                segment_writer=self._segment_writer(st, leased)
                if stats else None,
                on_payload=on_payload)
        except wire.WireError as e:
            # the RESPONSE broke the frame limit (e.g. a scan returned more
            # region bytes than max_frame_bytes): tell the client instead
            # of silently dropping the connection
            self._release_leases(st, leased)
            leased = []
            payload = wire.dumps(wire.error_doc(doc.get("id"), e),
                                 codec=self.codec,
                                 max_bytes=self.max_frame_bytes)
        delivered = False
        try:
            st.outq.put_nowait(payload)
            delivered = True
        except queue.Full:
            # slow consumer: hundreds of unread responses queued — cut it
            # loose rather than buffer unboundedly (its writer thread may
            # be stuck in sendall; shutdown() unsticks that too)
            try:
                st.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                st.sock.close()
            except OSError:
                pass
        # leases racing connection teardown: _serve_conn sets st.closed
        # BEFORE release_owner, we re-check closed AFTER leasing — one of
        # the two sides is guaranteed to observe the other's write, so a
        # segment can't slip past both and leak
        if leased and (not delivered or st.closed):
            self._release_leases(st, leased)

    def _release_leases(self, st: _ConnState, names: list) -> None:
        if names and self._shm_pool is not None:
            self._shm_pool.release(names, owner=st)

    # -------------------------------------------------- reply marshalling
    def _offload_marshal(self, fn, *args) -> None:
        """Run a reply-marshalling job on the store's scheduler pool (the
        decode workers, idle between batches), falling back to a
        server-owned pool when the store has none (the cluster router
        duck-types the store surface without a scheduler), and to inline
        execution when the pools are draining at shutdown."""
        sched = getattr(self.store, "scheduler", None)
        try:
            if sched is not None:
                sched.offload(fn, *args)
                return
            with self._marshal_lock:
                if self._marshal_pool is None:
                    self._marshal_pool = ThreadPoolExecutor(
                        max_workers=max(os.cpu_count() or 1, 2),
                        thread_name_prefix="tasm-marshal")
                pool = self._marshal_pool
            pool.submit(fn, *args)
        except RuntimeError:  # racing shutdown: last replies go inline
            fn(*args)

    def _marshal_scan_reply(self, st: _ConnState, rid, res,
                            want_plan: bool) -> None:
        try:
            resp = wire.result_doc(rid, self._result_doc(res, want_plan))
        except BaseException as e:  # noqa: BLE001 - to client
            self._send(st, wire.error_doc(rid, e))
            return
        self._send(st, resp, stats=[res.stats])

    # ----------------------------------------------------------- dispatch
    def _dispatch(self, st: _ConnState, req) -> None:
        rid = req.get("id") if isinstance(req, dict) else None
        try:
            if not isinstance(req, dict) or "op" not in req:
                raise ValueError("request frame has no 'op'")
            op = req["op"]
            if op == "scan":
                # async: the response is written from the future callback,
                # so this connection can pipeline more requests meanwhile
                fut = self._session.submit(ScanPlan.from_doc(req["plan"]))
                want_plan = bool(req.get("want_plan", True))

                def _done(f, rid=rid):
                    try:
                        res = f.result()
                    except BaseException as e:  # noqa: BLE001 - to client
                        self._send(st, wire.error_doc(rid, e))
                        return
                    # the callback runs on the shared session's dispatcher
                    # thread — marshalling there would serialize every
                    # client's replies behind one GIL-bound loop, so hand
                    # the doc building + payload packing to the pool
                    self._offload_marshal(self._marshal_scan_reply,
                                          st, rid, res, want_plan)

                fut.add_done_callback(_done)
                return
            if op == "execute_many":
                # one submission wave through the shared session: same
                # micro-batch, results strictly in submission order
                futs = [self._session.submit(ScanPlan.from_doc(p))
                        for p in req["plans"]]
                want_plan = bool(req.get("want_plan", True))
                results = [f.result() for f in futs]
                value = [self._result_doc(r, want_plan) for r in results]
                self._send(st, wire.result_doc(rid, value),
                           stats=[r.stats for r in results])
                return
            if op in ("shm_probe", "shm_enable", "shm_release"):
                value = self._handle_shm(op, req, st)
            else:
                value = self._handle(op, req)
                if op == "ping":
                    value["transport"] = "shm" if st.shm else "npz"
                elif op == "stats" and isinstance(value, dict):
                    value["shm"] = self._shm_pool.stats() \
                        if self._shm_pool is not None \
                        else {"segments": 0, "bytes": 0}
        except BaseException as e:  # noqa: BLE001 - mapped to error frame
            self._send(st, wire.error_doc(rid, e))
            return
        self._send(st, wire.result_doc(rid, value))
        if req.get("op") == "shutdown":
            # stop from a helper thread (stop() tears down connection
            # machinery this thread is part of) — but only after the
            # writer has flushed the queued reply, else stop()'s
            # connection close races the send and the client sees EOF
            # instead of its acknowledgement
            flushed = threading.Event()
            st.outq.put(flushed)

            def _stop_after_flush():
                flushed.wait(timeout=10)  # a non-reading client can't
                self.stop()               # hold shutdown hostage

            threading.Thread(target=_stop_after_flush,
                             daemon=True).start()

    def _result_doc(self, res, want_plan: bool) -> dict:
        return res.to_doc(include_plan=want_plan)

    # ------------------------------------------------- shm lease protocol
    def _handle_shm(self, op: str, req: dict, st: _ConnState):
        """Transport negotiation + lease release.  ``shm_probe`` leases a
        nonce segment; the client proves it genuinely shares /dev/shm
        (same-host, same namespace — not a TCP peer with a coincidental
        segment name) by echoing the nonce through ``shm_enable``."""
        if op == "shm_release":
            if self._shm_pool is not None:
                self._shm_pool.release(
                    [str(n) for n in req.get("segments") or []], owner=st)
            return True
        if self._shm_pool is None or self.transport == "socket":
            if op == "shm_probe":
                return {"enabled": False}
            return False  # shm_enable against a socket-only server
        if op == "shm_probe":
            name, nbytes = self._shm_pool.probe(owner=st)
            return {"enabled": True, "segment": name, "nbytes": nbytes}
        # shm_enable: verify the nonce readback, then release the probe
        ok = self._shm_pool.verify(str(req.get("segment")),
                                   str(req.get("nonce")))
        self._shm_pool.release([str(req.get("segment"))], owner=st)
        if ok:
            st.shm = True
        return ok

    # ------------------------------------------------------------- ops
    def _handle(self, op: str, req: dict):
        store = self.store
        if op == "ping":
            # doubles as the router tier's node-health probe, so carry
            # enough state for a cheap liveness + capacity check
            return {"pong": True, "pid": os.getpid(),
                    "codec": self.codec or wire.default_codec(),
                    "videos": len(store)}
        if op == "videos":
            return store.videos()
        if op == "add_video":
            store.add_video(req["name"], **_video_kw_from_doc(req))
            return True
        if op == "ingest":
            dets = req.get("detections")
            layouts = req.get("initial_layouts")
            stats = store.ingest(
                req["name"], req["frames"],
                detections=None if dets is None
                else [[(label, tuple(int(c) for c in bbox))
                       for label, bbox in frame_dets]
                      for frame_dets in dets],
                initial_layouts=None if layouts is None
                else {int(s): TileLayout(tuple(h), tuple(w))
                      for s, h, w in layouts},
                **_video_kw_from_doc(req))
            doc = dataclasses.asdict(stats)
            # replica-aware acknowledgement: the post-ingest epoch table
            # rides along so a router writing K replicas can verify they
            # all landed on the same physical generation without a second
            # round-trip (pairs, not a dict — JSON would stringify int
            # keys)
            doc["epochs"] = [[s, e]
                             for s, e in store.epochs(req["name"]).items()]
            return doc
        if op == "add_detections":
            store.add_detections(req["video"],
                                 _detections_from_doc(req["pairs"]))
            return True
        if op == "add_metadata":
            store.add_metadata(req["video"], int(req["frame"]),
                               req["label"], int(req["x1"]), int(req["y1"]),
                               int(req["x2"]), int(req["y2"]))
            return True
        if op == "explain":
            return store.lower(ScanPlan.from_doc(req["plan"])).to_doc()
        if op == "retile":
            layout = TileLayout(tuple(int(h) for h in req["heights"]),
                                tuple(int(w) for w in req["widths"]))
            return store.retile(req["video"], int(req["sot_id"]), layout)
        if op == "drain_tuner":
            return dataclasses.asdict(store.drain_tuner(req.get("timeout")))
        if op == "tuner_stats":
            return dataclasses.asdict(store.tuner_stats())
        if op == "drain_prefetch":
            return dataclasses.asdict(store.drain_prefetch(
                req.get("timeout")))
        if op == "config":
            return store.config()
        if op == "epochs":
            return [[s, e] for s, e in store.epochs(req["video"]).items()]
        # -- replica streaming (the cluster repair data plane): each chunk
        # is one request/reply frame, so copies are resumable at chunk
        # granularity and ride the same wire/codec as everything else
        if op == "export_meta":
            return store.export_entry(req["video"])
        if op == "export_chunk":
            return store.export_tile(req["video"], int(req["sot_id"]),
                                     int(req["tile_idx"]))
        if op == "import_begin":
            return store.begin_import(req["video"])
        if op == "import_chunk":
            store.stage_import_chunk(req["video"], int(req["sot_id"]),
                                     int(req["epoch"]), int(req["tile_idx"]),
                                     req["enc"], str(req["checksum"]))
            return True
        if op == "import_commit":
            min_epochs = {int(s): int(e)
                          for s, e in (req.get("min_epochs") or [])}
            return store.commit_import(req["video"], req["doc"],
                                       min_epochs=min_epochs)
        if op == "import_abort":
            store.abort_import(req["video"])
            return True
        if op == "stats":
            return store.stats()
        if op == "shutdown":
            return True  # the dispatcher stops the server after replying
        raise ValueError(f"unknown op {op!r}")
