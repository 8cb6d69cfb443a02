"""Wire layer for cross-process serving (``server.py`` / ``client.py``).

Framing: every message is one *frame* — a 4-byte big-endian payload length
followed by the payload.  The payload's first byte tags the codec::

    b"M"  msgpack (when the optional ``msgpack`` package is installed)
    b"J"  UTF-8 JSON (always available — the CI fallback)

Both sides decode by tag, so a JSON-only client can talk to an
msgpack-capable server and vice versa; the sender picks the best codec it
has (override with ``REPRO_TORCH_WIRE=json|msgpack`` or the ``codec=``
argument).  The environment name carries the port's prefix, so this
package and the reference never steer each other.

Messages are JSON-able dicts *except* numpy arrays: :func:`dumps` walks the
doc, replaces each ``np.ndarray`` with a ``{"__nd__": i}`` reference and
ships the arrays in a single npz blob riding alongside the doc (raw bytes
under msgpack, base64 under JSON).  :func:`loads` reverses the walk, so
region crops and ingest frames round-trip bit-identically with their
dtype/shape intact (``allow_pickle`` stays off — object arrays are
rejected, not smuggled).

Payload transport is swappable per frame: instead of the npz blob a frame
may carry an ``"s"`` shared-memory descriptor — ``{"seg": name, "items":
[[offset, shape, dtype], ...]}`` indexed like the array list — produced by
a ``segment_writer`` (the server's :class:`~repro_torch.core.shm.SegmentPool`)
and resolved by an ``shm_reader`` (the client maps the segment and builds
zero-copy numpy views).  A writer returning ``None`` (remote peer, pool
exhausted, /dev/shm missing) falls back to the npz blob in the same
frame format, so both transports decode through one :func:`loads`.

Oversized frames are rejected on BOTH sides before any payload allocation:
:func:`dumps` raises when the encoded frame would exceed ``max_bytes`` and
:func:`read_frame` raises after reading only the 4-byte header, so a
misbehaving (or malicious) peer cannot force the server to materialize an
arbitrarily large buffer.  The server answers with an error frame and
closes that connection; other connections are unaffected.
"""
from __future__ import annotations

import base64
import io
import json
import os
import socket
import struct
from typing import Any, Optional

import numpy as np

try:  # optional: baked into the container; CI's bare install falls to JSON
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - environment-dependent
    _msgpack = None

#: refuse frames larger than this by default (header-checked, pre-alloc)
DEFAULT_MAX_FRAME_BYTES = 256 << 20  # 256 MiB

_HEADER = struct.Struct(">I")
_TAG_MSGPACK = b"M"
_TAG_JSON = b"J"
_ND_KEY = "__nd__"


class WireError(Exception):
    """Malformed, oversized, or undecodable frame."""


class ConnectionClosed(WireError):
    """The peer closed the socket (mid-frame close is a plain WireError)."""


def default_codec() -> str:
    """'msgpack' when available, else 'json'; ``REPRO_TORCH_WIRE``
    overrides."""
    env = os.environ.get("REPRO_TORCH_WIRE")
    if env:
        if env not in ("json", "msgpack"):
            raise ValueError(f"REPRO_TORCH_WIRE={env!r}; want json|msgpack")
        if env == "msgpack" and _msgpack is None:
            raise ValueError("REPRO_TORCH_WIRE=msgpack but msgpack is not "
                             "installed")
        return env
    return "msgpack" if _msgpack is not None else "json"


# ----------------------------------------------------------- ndarray walk
def _extract_arrays(obj: Any, arrays: list[np.ndarray]) -> Any:
    """Deep-copy ``obj`` with every ndarray swapped for an ``__nd__`` ref.
    Tuples become lists (the codecs don't distinguish them; the query-layer
    ``from_doc`` restorers re-tuple what must be hashable)."""
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            # reject on the SENDER: np.savez would silently pickle these,
            # and the receiver's allow_pickle=False rejection surfaces as
            # an uncorrelatable connection-level error
            raise WireError(f"object-dtype array ({obj.dtype}) cannot "
                            "cross the wire")
        arrays.append(obj)
        return {_ND_KEY: len(arrays) - 1}
    if isinstance(obj, dict):
        return {k: _extract_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_extract_arrays(v, arrays) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def _restore_arrays(obj: Any, lookup) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {_ND_KEY}:
            return lookup(obj[_ND_KEY])
        return {k: _restore_arrays(v, lookup) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore_arrays(v, lookup) for v in obj]
    return obj


def _pack_npz(arrays: list[np.ndarray]) -> tuple[bytes, list]:
    """Pack arrays into one npz blob, STACKING same-(dtype, shape) arrays
    into a single member: a scan result carries one small crop per region,
    and zip-member overhead (header + crc per entry) would otherwise
    dominate the wire cost of a warm scan.  Returns ``(blob, index)`` where
    ``index[i] = [member, pos]`` locates array ``i`` (``pos`` = -1 for a
    member holding exactly that array un-stacked)."""
    groups: dict[tuple, list[int]] = {}
    for i, a in enumerate(arrays):
        groups.setdefault((str(a.dtype), a.shape), []).append(i)
    members: dict[str, np.ndarray] = {}
    index: list = [None] * len(arrays)
    for g, idxs in enumerate(groups.values()):
        name = f"g{g}"
        if len(idxs) == 1:
            members[name] = arrays[idxs[0]]
            index[idxs[0]] = [name, -1]
        else:
            members[name] = np.stack([arrays[i] for i in idxs])
            for pos, i in enumerate(idxs):
                index[i] = [name, pos]
    buf = io.BytesIO()
    np.savez(buf, **members)
    return buf.getvalue(), index


# ------------------------------------------------------------ dumps/loads
def dumps(doc: dict, *, codec: Optional[str] = None,
          max_bytes: int = DEFAULT_MAX_FRAME_BYTES,
          segment_writer=None, on_payload=None) -> bytes:
    """Encode one message to a tagged payload (no length prefix).

    ``segment_writer(arrays)`` — when given — is offered the frame's
    array list first; if it returns a shared-memory descriptor doc the
    frame ships that (``"s"``) instead of the npz blob, and if it returns
    ``None`` the npz path proceeds unchanged.  ``on_payload(clean,
    transport, payload_bytes)`` fires after array packing (the dominant
    marshalling cost) but *before* the envelope encode, so a caller can
    stamp marshalling accounting into the outgoing doc itself."""
    codec = codec or default_codec()
    arrays: list[np.ndarray] = []
    clean = _extract_arrays(doc, arrays)
    blob, index, shm_doc = None, None, None
    if arrays:
        if segment_writer is not None:
            shm_doc = segment_writer(arrays)
        if shm_doc is None:
            blob, index = _pack_npz(arrays)
    if on_payload is not None:
        nbytes = len(blob) if blob is not None else \
            sum(int(a.nbytes) for a in arrays)
        on_payload(clean, "shm" if shm_doc is not None else "npz", nbytes)
    if codec == "msgpack":
        if _msgpack is None:
            raise WireError("msgpack codec requested but not installed")
        payload = _TAG_MSGPACK + _msgpack.packb(
            {"d": clean, "z": blob, "zi": index, "s": shm_doc},
            use_bin_type=True)
    else:
        payload = _TAG_JSON + json.dumps(
            {"d": clean,
             "z": base64.b64encode(blob).decode("ascii") if blob else None,
             "zi": index, "s": shm_doc},
            separators=(",", ":")).encode("utf-8")
    if len(payload) > max_bytes:
        raise WireError(f"frame of {len(payload)} bytes exceeds the "
                        f"{max_bytes}-byte limit")
    return payload


def loads(payload: bytes, *, shm_reader=None) -> dict:
    """Decode a tagged payload back to its message doc.

    ``shm_reader(shm_doc)`` — when given — resolves an ``"s"``
    shared-memory descriptor to the list of arrays it describes (index-
    aligned with the frame's ``__nd__`` refs).  A frame carrying ``"s"``
    with no reader installed raises: silently returning refs would hand
    the caller descriptor dicts where arrays belong."""
    if not payload:
        raise WireError("empty frame payload")
    tag, body = payload[:1], payload[1:]
    try:
        if tag == _TAG_MSGPACK:
            if _msgpack is None:
                raise WireError("received an msgpack frame but msgpack is "
                                "not installed (peer should fall back to "
                                "JSON)")
            msg = _msgpack.unpackb(body, raw=False,
                                   max_bin_len=len(body),
                                   strict_map_key=False)
        elif tag == _TAG_JSON:
            msg = json.loads(body.decode("utf-8"))
        else:
            raise WireError(f"unknown frame codec tag {tag!r}")
        if not isinstance(msg, dict) or "d" not in msg:
            raise WireError("frame payload is not a message envelope")
        blob = msg.get("z")
        if isinstance(blob, str):  # JSON ships the npz blob base64'd
            blob = base64.b64decode(blob)
        lookup = None
        shm_doc = msg.get("s")
        if shm_doc is not None:
            if shm_reader is None:
                raise WireError("frame carries a shared-memory payload "
                                "but no shm reader is installed")
            views = shm_reader(shm_doc)

            def lookup(i: int, views=views):
                return views[i]

        elif blob:
            npz = np.load(io.BytesIO(blob), allow_pickle=False)
            index = msg.get("zi") or []
            members: dict[str, np.ndarray] = {}

            def lookup(i: int, npz=npz, index=index, members=members):
                name, pos = index[i]
                if name not in members:
                    members[name] = npz[name]  # decompress each member once
                arr = members[name]
                return arr if pos < 0 else arr[pos]

        return _restore_arrays(msg["d"], lookup)
    except WireError:
        raise
    except Exception as e:  # corrupt msgpack/json/base64/npz alike
        raise WireError(f"undecodable frame: {type(e).__name__}: {e}") \
            from e


# ---------------------------------------------------------------- sockets
def write_frame(sock: socket.socket, doc: dict, *,
                codec: Optional[str] = None,
                max_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> None:
    payload = dumps(doc, codec=codec, max_bytes=max_bytes)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _read_exact(sock: socket.socket, n: int, *, eof_ok: bool) -> bytes:
    """Read exactly ``n`` bytes, tolerant of arbitrarily fragmented
    ``recv`` returns (a peer dribbling one byte at a time, or a header
    split across TCP segments, reassembles identically).  Fills a single
    preallocated buffer via ``recv_into`` so a heavily fragmented frame
    costs no per-chunk allocations or a final join."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if r == 0:
            if eof_ok and got == 0:
                raise ConnectionClosed("peer closed the connection")
            raise WireError("connection closed mid-frame")
        got += r
    return bytes(buf)


def read_frame(sock: socket.socket, *,
               max_bytes: int = DEFAULT_MAX_FRAME_BYTES,
               shm_reader=None) -> dict:
    """Read one frame; raises :class:`ConnectionClosed` on a clean EOF
    between frames, :class:`WireError` on truncation, oversize, or an
    undecodable payload.  The length header is validated BEFORE the payload
    is read, so an oversized frame never allocates its claimed size."""
    header = _read_exact(sock, _HEADER.size, eof_ok=True)
    (length,) = _HEADER.unpack(header)
    if length > max_bytes:
        raise WireError(f"peer announced a {length}-byte frame; limit is "
                        f"{max_bytes}")
    if length == 0:
        raise WireError("zero-length frame")
    return loads(_read_exact(sock, length, eof_ok=False),
                 shm_reader=shm_reader)


# -------------------------------------------------------------- RPC docs
def error_doc(rid, exc: BaseException) -> dict:
    """Error response frame for a failed request (``rid`` may be None when
    the request was too malformed to carry an id)."""
    return {"id": rid, "ok": False,
            "error": {"type": type(exc).__name__, "message": str(exc)}}


def result_doc(rid, value) -> dict:
    return {"id": rid, "ok": True, "value": value}
