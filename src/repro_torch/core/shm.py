"""Shared-memory segment pool for zero-copy serving (``server.py``).

The socket transport of ``wire.py`` copies every region crop four times on
its way to a local client: ndarray -> npz blob -> socket -> client buffer
-> ndarray.  For clients on the SAME host none of those copies is needed:
the server writes each reply's arrays once into a
``multiprocessing.shared_memory`` segment and ships only ``(segment,
offset, shape, dtype)`` descriptors over the socket; the client maps the
segment and builds numpy views directly onto the shared pages.  Bits are
preserved exactly — a memcpy into shared pages is as lossless as the npz
round-trip — so results stay bit-identical to in-process ``execute()``.

Lifecycle (refcounted lease): one segment per reply, owned by the server's
:class:`SegmentPool` and *leased* to the connection the reply went to.
The client releases the lease with an ``shm_release`` RPC once the last
view is garbage-collected (or on ``close()``); the server then unlinks the
segment.  POSIX shm semantics make this safe against races: ``unlink``
removes the *name*, but pages stay valid until the last process unmaps
them, so a client still holding views keeps reading good data even after
the server reclaimed the name.  Segments are never re-used — "recycle"
means unlink — which keeps the protocol free of generation counters.

Crash-safety: every segment records its owning connection, so a client
that vanishes without releasing (SIGKILL, dropped socket) is reclaimed by
the server's connection-drop sweep.  CPython's resource tracker would
normally fight this ownership model — attaching processes register the
segment and unlink it on exit (bpo-39959) — so :func:`attach_segment`
untracks client-side mappings and the pool tolerates an already-unlinked
name.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Optional

import numpy as np

try:  # denied on some sandboxes (/dev/shm unavailable) — probe, don't die
    from multiprocessing import shared_memory as _shared_memory
except ImportError:  # pragma: no cover - environment-dependent
    _shared_memory = None

#: transport modes accepted by the server, the client, and
#: $REPRO_TORCH_TRANSPORT (the port's own name: the reference reads
#: $REPRO_TRANSPORT)
TRANSPORTS = ("auto", "shm", "socket")

#: default pool budget; ``write`` falls back to npz when it would overflow
DEFAULT_POOL_BYTES = 1 << 30  # 1 GiB

_ALIGN = 64  # cache-line align each array within its segment

#: names created by a pool in THIS process.  ``attach_segment`` must skip
#: its resource-tracker unregister for these: in-process clients (tests,
#: quickstart) share the creator's tracker, where create+attach collapse
#: to ONE registration — unregistering on attach would strip it and make
#: the pool's eventual unlink a double-unregister (tracker stderr noise).
_OWNED_NAMES: set = set()


def resolve_transport(value: Optional[str],
                      env: str = "REPRO_TORCH_TRANSPORT") -> str:
    """Resolve a transport request: explicit ``value`` wins, then the
    ``$REPRO_TORCH_TRANSPORT`` override, then ``"auto"``.  Rejected values
    raise (mirrors ``wire.default_codec``'s ``REPRO_TORCH_WIRE``
    contract)."""
    if value is None:
        value = os.environ.get(env) or "auto"
        origin = f"{env}={value!r}"
    else:
        origin = f"transport={value!r}"
    if value not in TRANSPORTS:
        raise ValueError(f"{origin}; want auto|shm|socket")
    return value


@functools.lru_cache(maxsize=1)
def shm_available() -> bool:
    """True when this host can create (and map) POSIX shared memory."""
    if _shared_memory is None:
        return False
    try:
        seg = _shared_memory.SharedMemory(create=True, size=1)
    except Exception:  # noqa: BLE001 - any failure means "no shm here"
        return False
    try:
        seg.close()
        seg.unlink()
    except Exception:  # noqa: BLE001 - best-effort cleanup
        pass
    return True


if _shared_memory is not None:
    class _MappedSegment(_shared_memory.SharedMemory):
        """Client-side mapping whose *destructor* tolerates live exports.

        ``close()`` still raises BufferError while numpy views hold the
        buffer — the client's janitor relies on that to retry — but at
        interpreter shutdown the teardown order of a lease and its views
        is arbitrary, and a plain SharedMemory.__del__ sprays
        "Exception ignored ... BufferError" to stderr when it loses the
        race.  The pages are reclaimed by the kernel either way."""

        def __del__(self):
            try:
                super().__del__()
            except BufferError:
                pass


def attach_segment(name: str):
    """Map an existing segment by name (client side).  The mapping is
    UNREGISTERED from this process's resource tracker: the tracker would
    otherwise unlink the server-owned name when this process exits
    (bpo-39959), yanking the segment out from under every other client."""
    if _shared_memory is None:
        raise RuntimeError("shared memory is unavailable on this host")
    seg = _MappedSegment(name=name)
    if name not in _OWNED_NAMES:
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(getattr(seg, "_name", seg.name),
                                        "shared_memory")
        except Exception:  # noqa: BLE001 - tracker varies by version
            pass
    return seg


def _unlink(seg) -> None:
    try:
        seg.unlink()
    except FileNotFoundError:
        pass  # a crashed client's tracker got there first — same outcome
    except OSError:  # pragma: no cover - platform-dependent
        pass


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _Segment:
    __slots__ = ("shm", "size", "owner", "nonce", "created")

    def __init__(self, shm, size: int, owner):
        self.shm = shm
        self.size = size
        self.owner = owner
        self.nonce: Optional[bytes] = None
        self.created = time.monotonic()


class SegmentPool:
    """Server-owned pool of leased shared-memory segments.

    ``write`` allocates one fresh segment per reply and copies the arrays
    in (64-byte aligned); ``release`` unlinks by name.  ``owner`` is an
    opaque per-connection token: ``release`` with an owner only honours
    names leased to that owner (a client cannot release its neighbour's
    segments), and ``release_owner``/``sweep`` reclaim everything a dead
    connection left behind.  All methods are thread-safe; ``write``
    returns ``None`` — the caller's cue to fall back to the npz payload —
    when the pool is closed, over budget, or shm allocation fails.
    """

    def __init__(self, *, max_bytes: int = DEFAULT_POOL_BYTES):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._segments: dict[str, _Segment] = {}
        self._bytes = 0
        self._closed = False

    # ------------------------------------------------------------ writing
    def write(self, arrays: list[np.ndarray],
              owner: Any = None) -> Optional[dict]:
        """Copy ``arrays`` into one new segment; returns the wire
        descriptor doc ``{"seg": name, "items": [[offset, shape, dtype],
        ...]}`` or ``None`` when the caller should fall back to npz."""
        if _shared_memory is None or not arrays:
            return None
        offsets: list[int] = []
        total = 0
        for a in arrays:
            total = _align(total)
            offsets.append(total)
            total += int(a.nbytes)
        size = max(total, 1)
        with self._lock:
            if self._closed or self._bytes + size > self.max_bytes:
                return None
            self._bytes += size  # reserve before the (unlocked) copy
        try:
            seg = _shared_memory.SharedMemory(create=True, size=size)
        except OSError:
            with self._lock:
                self._bytes -= size
            return None
        try:
            for a, off in zip(arrays, offsets):
                if a.nbytes:
                    dst = np.ndarray(a.shape, dtype=a.dtype,
                                     buffer=seg.buf, offset=off)
                    dst[...] = a
                    del dst
        finally:
            # drop the server's mapping NOW: the name (held in _Segment
            # for unlink) is what keeps the pages alive, and an idle
            # server should not hold a vma per outstanding lease
            try:
                seg.close()
            except BufferError:  # pragma: no cover - exports still alive
                pass
        rec = _Segment(seg, size, owner)
        _OWNED_NAMES.add(seg.name)
        with self._lock:
            if self._closed:  # raced close(): reclaim immediately
                self._bytes -= size
            else:
                self._segments[seg.name] = rec
                rec = None
        if rec is not None:
            _unlink(rec.shm)
            _OWNED_NAMES.discard(seg.name)
            return None
        return {"seg": seg.name,
                "items": [[off, list(a.shape), str(a.dtype)]
                          for a, off in zip(arrays, offsets)]}

    # -------------------------------------------------------- negotiation
    def probe(self, owner: Any = None) -> tuple[str, int]:
        """Allocate a nonce segment for transport negotiation: the client
        proves /dev/shm is genuinely shared (not a container-private
        namespace that happens to exist on both sides) by reading the
        nonce back.  Returns ``(segment_name, nonce_length)``."""
        nonce = os.urandom(16)
        doc = self.write([np.frombuffer(nonce, dtype=np.uint8)],
                         owner=owner)
        if doc is None:
            raise RuntimeError("shared-memory pool closed or exhausted")
        with self._lock:
            rec = self._segments.get(doc["seg"])
            if rec is not None:
                rec.nonce = nonce
        return doc["seg"], len(nonce)

    def verify(self, name: str, nonce_hex: str) -> bool:
        """Check a probe readback; the probe segment stays leased to its
        owner and is reclaimed like any reply segment."""
        try:
            nonce = bytes.fromhex(nonce_hex)
        except (TypeError, ValueError):
            return False
        with self._lock:
            rec = self._segments.get(name)
            return (rec is not None and rec.nonce is not None
                    and rec.nonce == nonce)

    # ------------------------------------------------------------ leases
    def release(self, names, owner: Any = None) -> int:
        """Unlink segments by name; with ``owner`` given, only names
        leased to that owner are honoured.  Unknown names are ignored
        (double releases and post-sweep stragglers are expected)."""
        freed = 0
        for name in names:
            with self._lock:
                rec = self._segments.get(str(name))
                if rec is None or (owner is not None
                                   and rec.owner is not owner):
                    continue
                del self._segments[str(name)]
                self._bytes -= rec.size
            _unlink(rec.shm)
            _OWNED_NAMES.discard(str(name))
            freed += 1
        return freed

    def release_owner(self, owner: Any) -> int:
        """Reclaim every segment leased to ``owner`` (connection drop)."""
        with self._lock:
            names = [n for n, r in self._segments.items()
                     if r.owner is owner]
        return self.release(names, owner=owner)

    def sweep(self, live_owners) -> int:
        """Reclaim segments whose owner is no longer in ``live_owners`` —
        the backstop for leases orphaned by a SIGKILLed client whose
        connection teardown raced a concurrent reply."""
        live = {id(o) for o in live_owners}
        with self._lock:
            names = [n for n, r in self._segments.items()
                     if r.owner is not None and id(r.owner) not in live]
        return self.release(names)

    # ------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._lock:
            return {"segments": len(self._segments), "bytes": self._bytes}

    def close(self) -> None:
        """Unlink everything.  Clients still holding views keep valid
        mappings (POSIX unlink-vs-mmap semantics); new ``write`` calls
        return ``None`` from here on."""
        with self._lock:
            self._closed = True
            names = list(self._segments)
        self.release(names)
