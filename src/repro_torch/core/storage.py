"""Tile-based physical storage (paper §3.4.5, Fig. 1).

Each SOT (sequence of tiles — a run of frames sharing one layout) stores one
independently decodable stream per tile:

    <root>/<video>/frames_<a>-<b>/tile<i>.npz

Retiling a SOT decodes every tile stream, re-encodes under the new layout,
and atomically replaces the SOT directory.  An in-memory mode (root=None)
backs unit tests; benchmarks use the on-disk layout.
"""
from __future__ import annotations

import hashlib
import pathlib
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.codec.batch import decode_tile_batch
from repro_torch.codec.encode import EncoderConfig, decode_tile, encode_tiles
from repro_torch.core.btree import BPlusTree
from repro_torch.core.layout import TileLayout, single_tile_layout
from repro_torch.kernels.decode.ops import resolve_device


@dataclass
class SOTRecord:
    sot_id: int
    frame_start: int
    frame_end: int
    layout: TileLayout
    epoch: int = 0
    size_bytes: float = 0.0


def tile_checksum(enc: dict) -> str:
    """Content digest of one encoded tile stream — scalar header plus every
    per-GOP quantized member, dtype/shape included so a reinterpreted buffer
    never collides.  The repair copy path verifies this end to end: computed
    on the source before the chunk ships, recomputed on the destination
    after the wire decode, and re-checked at commit before the replica
    flips live."""
    h = hashlib.sha256()
    h.update(np.array([enc["h"], enc["w"], enc["gop"], enc["qp"],
                       enc["n_frames"]], dtype=np.int64).tobytes())
    h.update(np.float64(enc["size_bytes"]).tobytes())
    for g in range(len(enc["kq"])):
        for member in (enc["kq"][g], enc["pq"][g]):
            a = np.ascontiguousarray(member)
            h.update(str(a.dtype).encode())
            h.update(np.array(a.shape, dtype=np.int64).tobytes())
            h.update(a.tobytes())
    return h.hexdigest()


#: decode_tiles implementations: "numpy" = the per-tile oracle loop,
#: "batched" = fused dispatches on the store's device (codec/batch.py)
DECODE_BACKENDS = ("numpy", "batched")


class TileStore:
    def __init__(self, video: str, encoder: EncoderConfig, *,
                 root: Optional[str] = None, sot_len: Optional[int] = None,
                 decode_backend: str = "batched", device="cuda"):
        self.video = video
        self.encoder = encoder
        self.sot_len = sot_len or encoder.gop  # default: one SOT per GOP
        assert self.sot_len % encoder.gop == 0, "SOT must cover whole GOPs"
        if decode_backend not in DECODE_BACKENDS:
            raise ValueError(f"decode_backend must be one of "
                             f"{DECODE_BACKENDS}, got {decode_backend!r}")
        self.decode_backend = decode_backend
        self.device = resolve_device(device)
        self.root = pathlib.Path(root) if root else None
        self._mem: dict[tuple[int, int, int], dict] = {}
        self.sots: list[SOTRecord] = []
        # B+-tree keyed on frame_start: interval lookup for sots_in_range
        self._intervals = BPlusTree(order=16)
        self.encode_seconds_total = 0.0
        # actual tile-stream decodes (cache hits in the serving layer never
        # reach this counter) — lets tests/benchmarks verify dedup exactly;
        # locked: group fetches decode concurrently on the worker pool.
        # pixels_decoded_total counts actual decoded pixels at 8x8-block
        # granularity (an ROI-restricted decode adds only its masked blocks)
        self.tiles_decoded_total = 0
        self.pixels_decoded_total = 0
        self._stats_lock = threading.Lock()

    # -- paths ---------------------------------------------------------------
    def _sot_dir(self, rec: SOTRecord) -> pathlib.Path:
        return (self.root / self.video /
                f"frames_{rec.frame_start}-{rec.frame_end - 1}")

    def _write_tile(self, rec: SOTRecord, tile_idx: int, enc: dict) -> None:
        if self.root is None:
            self._mem[(rec.sot_id, rec.epoch, tile_idx)] = enc
            return
        d = self._sot_dir(rec)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f".tile{tile_idx}.tmp.npz"
        # one zip member per GOP so a prefix read (temporal random access)
        # decompresses only the GOPs it needs instead of the whole stream
        gops = {}
        for g in range(len(enc["kq"])):
            gops[f"kq_{g}"] = enc["kq"][g]
            gops[f"pq_{g}"] = enc["pq"][g]
        np.savez_compressed(tmp,
                            meta=np.array([enc["h"], enc["w"], enc["gop"],
                                           enc["qp"], enc["n_frames"]]),
                            size=np.array([enc["size_bytes"]]), **gops)
        tmp.rename(d / f"tile{tile_idx}.npz")

    def _read_tile(self, rec: SOTRecord, tile_idx: int, *,
                   n_gops: int | None = None) -> dict:
        """Load an encoded tile; ``n_gops`` limits materialization to the
        first n GOPs (a prefix read never touches the rest of the stream —
        on disk, npz members beyond the prefix are not even decompressed)."""
        if self.root is None:
            enc = self._mem[(rec.sot_id, rec.epoch, tile_idx)]
            if n_gops is None or n_gops >= len(enc["kq"]):
                return enc
            return {**enc, "kq": enc["kq"][:n_gops], "pq": enc["pq"][:n_gops]}
        with np.load(self._sot_dir(rec) / f"tile{tile_idx}.npz") as z:
            h, w, gop, qp, n_frames = (int(x) for x in z["meta"])
            total = n_frames // gop
            k = total if n_gops is None else min(n_gops, total)
            if "kq" in z.files:   # legacy layout: one member for all GOPs
                kq, pq = z["kq"][:k], z["pq"][:k]
            else:
                kq = [z[f"kq_{g}"] for g in range(k)]
                pq = [z[f"pq_{g}"] for g in range(k)]
            return {"kq": kq, "pq": pq, "h": h, "w": w, "gop": gop,
                    "qp": qp, "n_frames": n_frames,
                    "size_bytes": float(z["size"][0])}

    # -- ingest ---------------------------------------------------------------
    def ingest(self, frames: np.ndarray,
               layouts: Optional[dict[int, TileLayout]] = None) -> float:
        """Encode the whole video.  layouts: sot_id -> layout (default ω).
        Returns encode seconds."""
        T, H, W = frames.shape
        assert T % self.sot_len == 0, (T, self.sot_len)
        n_sots = T // self.sot_len
        t0 = time.perf_counter()
        for s in range(n_sots):
            a, b = s * self.sot_len, (s + 1) * self.sot_len
            layout = (layouts or {}).get(s, single_tile_layout(H, W))
            rec = SOTRecord(s, a, b, layout)
            self._encode_sot(rec, frames[a:b])
            self._register(rec)
        dt = time.perf_counter() - t0
        self.encode_seconds_total += dt
        return dt

    @classmethod
    def from_arrays(cls, video: str, encoder: EncoderConfig,
                    records: list[SOTRecord], tiles: dict, **kw) -> "TileStore":
        """An in-memory store that adopts already-encoded tiles:
        ``tiles`` maps ``(sot_id, epoch, tile_idx)`` to the enc dict of
        numpy arrays that ``encode_tile`` returns (e.g. the reference
        package's in-memory tiles).  ``kw`` as for the constructor."""
        if records and "sot_len" not in kw:
            kw["sot_len"] = records[0].frame_end - records[0].frame_start
        store = cls(video, encoder, **kw)
        for rec in records:
            for t in range(rec.layout.n_tiles):
                store._write_tile(rec, t, tiles[(rec.sot_id, rec.epoch, t)])
            store._register(rec)
        return store

    def _register(self, rec: SOTRecord) -> None:
        self.sots.append(rec)
        self._intervals.insert(rec.frame_start, rec)

    def restore(self, records: list[SOTRecord]) -> None:
        """Adopt SOT records from a persisted manifest (tile data already on
        disk); only valid for on-disk stores."""
        assert self.root is not None, "cannot restore an in-memory store"
        for rec in records:
            self._register(rec)

    def _encode_sot(self, rec: SOTRecord, frames: np.ndarray) -> None:
        """Encode every tile of the SOT at once on the store's device
        (``encode_tiles``); it returns host arrays only after synchronising
        the device, so the callers' encode seconds include the device's
        work."""
        total = 0.0
        encs = encode_tiles(frames, rec.layout.tile_rects(), self.encoder,
                            device=self.device)
        for i, enc in enumerate(encs):
            self._write_tile(rec, i, enc)
            total += enc["size_bytes"]
        rec.size_bytes = total

    # -- decode ----------------------------------------------------------------
    def decode_tiles(self, sot_id: int, tile_idxs, *,
                     n_frames=None,
                     blocks: Optional[dict] = None) -> dict[int, np.ndarray]:
        """Decode the given tile streams of a SOT up to n_frames.  Whole GOPs
        except the last, which stops at the last requested frame (temporal
        random access never decodes past the request).  ``n_frames`` is one
        depth for every tile, or a ``tile_idx -> depth`` dict (a merged
        group fetch decodes each tile only as deep as its deepest consumer).

        ``blocks``: optional ``tile_idx -> block mask`` (sorted tile-local
        8x8-block indices, or ``None`` for the full tile) — ROI-restricted
        decode: only masked blocks are dequantized/transformed, the rest of
        each returned array stays zero (see ``decode_tile``).  Tiles absent
        from the dict decode fully.

        With ``decode_backend="batched"`` every (tile, GOP, mask) selection
        of the call is flattened into fused dispatches on the store's device
        (``codec/batch.py``) instead of the per-tile numpy loop; the decode
        counters are identical either way, the arrays equal to float32
        rounding."""
        rec = self.sots[sot_id]
        span = rec.frame_end - rec.frame_start
        gop = self.encoder.gop
        tile_idxs = list(tile_idxs)
        if isinstance(n_frames, dict):
            depth = {t: min(n_frames.get(t, span), span) for t in tile_idxs}
        else:
            nf = span if n_frames is None else min(n_frames, span)
            depth = {t: nf for t in tile_idxs}
        out = {}
        pixels = 0
        plan = []   # (tile, enc, n_full, tail, mask)
        for t in tile_idxs:
            nf = depth[t]
            n_full = nf // gop
            tail = nf - n_full * gop
            n_gops = n_full + (1 if tail else 0)
            enc = self._read_tile(rec, t, n_gops=n_gops)
            mask = (blocks or {}).get(t)
            n_blocks = (enc["h"] // 8) * (enc["w"] // 8) if mask is None \
                else len(mask)
            pixels += n_blocks * 64 * nf
            plan.append((t, enc, n_full, tail, mask))
        if self.decode_backend == "batched":
            owners, items = [], []
            for t, enc, n_full, tail, mask in plan:
                if n_full:
                    owners.append(t)
                    items.append((enc, list(range(n_full)), None, mask))
                if tail:
                    owners.append(t)
                    items.append((enc, [n_full], tail, mask))
            parts_by_tile: dict[int, list] = {}
            for t, arr in zip(owners, decode_tile_batch(
                    items, device=self.device)):
                parts_by_tile.setdefault(t, []).append(arr)
            for t, parts in parts_by_tile.items():
                out[t] = (np.concatenate(parts, axis=0) if len(parts) > 1
                          else parts[0])
        else:
            for t, enc, n_full, tail, mask in plan:
                parts = []
                if n_full:
                    parts.append(decode_tile(enc, gop_indices=range(n_full),
                                             blocks=mask))
                if tail:
                    parts.append(decode_tile(enc, gop_indices=[n_full],
                                             frames_within=tail, blocks=mask))
                out[t] = (np.concatenate(parts, axis=0) if len(parts) > 1
                          else parts[0])
        with self._stats_lock:
            self.tiles_decoded_total += len(tile_idxs)
            self.pixels_decoded_total += pixels
        return out

    def decode_full_sot(self, sot_id: int) -> np.ndarray:
        """Reassemble all tiles of a SOT into full frames (stitching)."""
        rec = self.sots[sot_id]
        tiles = self.decode_tiles(sot_id, range(rec.layout.n_tiles))
        T = rec.frame_end - rec.frame_start
        H, W = rec.layout.frame_height, rec.layout.frame_width
        frames = np.zeros((T, H, W), dtype=np.float32)
        for i, (y1, x1, y2, x2) in enumerate(rec.layout.tile_rects()):
            frames[:, y1:y2, x1:x2] = tiles[i][:T]
        return frames

    # -- retile -----------------------------------------------------------------
    def retile(self, sot_id: int, new_layout: TileLayout) -> float:
        """Decode + re-encode a SOT under a new layout.  Returns seconds."""
        rec = self.sots[sot_id]
        if new_layout == rec.layout:
            return 0.0
        t0 = time.perf_counter()
        frames = self.decode_full_sot(sot_id)
        old_dir = self._sot_dir(rec) if self.root is not None else None
        old_epoch = rec.epoch
        rec.layout = new_layout
        rec.epoch += 1
        if old_dir is not None and old_dir.exists():
            shutil.rmtree(old_dir)
        self._encode_sot(rec, frames)
        # drop in-memory blobs of the previous epoch
        if self.root is None:
            for k in [k for k in self._mem if k[0] == sot_id and k[1] == old_epoch]:
                del self._mem[k]
        dt = time.perf_counter() - t0
        self.encode_seconds_total += dt
        return dt

    # -- stats -------------------------------------------------------------------
    def storage_bytes(self) -> float:
        return float(sum(r.size_bytes for r in self.sots))

    def sots_in_range(self, f_lo: int, f_hi: int) -> list[SOTRecord]:
        """SOTs overlapping [f_lo, f_hi), ascending — an O(log n + k)
        range scan of the frame-interval B+-tree (SOTs are fixed-length, so
        any overlapping SOT starts at or after f_lo - sot_len + 1)."""
        lo_key = max(0, f_lo - self.sot_len + 1)
        return [rec for _, recs in self._intervals.scan(lo_key, f_hi)
                for rec in recs if rec.frame_end > f_lo]
