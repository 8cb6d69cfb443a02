"""Serve a VideoStore of the PyTorch/CUDA port to many client processes over
a socket.

    PYTHONPATH=src python -m repro_torch.tasm_serve --socket /tmp/tasm.sock \\
        --store-root /data/tasm
    PYTHONPATH=src python -m repro_torch.tasm_serve --tcp 0.0.0.0:7841
    PYTHONPATH=src python -m repro_torch.tasm_serve --socket s --device cpu

Clients connect with :class:`repro_torch.core.RemoteVideoStore` (same
declarative surface — ``scan(v).labels(...).frames(...).execute()``,
``execute_many``, ``serve()`` sessions, ``ingest``/``add_detections``/
``retile``/…) and share ONE scheduler, tile cache, background tuner and
card, so overlapping queries from different processes merge their decodes
and warm each other.

The store decodes and encodes on ``--device`` (``cuda`` by default): the
scan path's decode kernel and the ingest/retile encode kernels run there.
Without a CUDA device, and without ``--device cpu``, the server refuses to
start and exits non-zero.  Ingest frames and scan replies ride wire frames
of at most ``--max-frame-mb`` (256 MiB by default: a 64-frame 1080p f32
ingest is 531 MB, so send such a video in pieces or raise the cap).
Shared-memory replies are pooled up to half the free space of
``/dev/shm`` at start, at most 1 GiB: the pool itself never checks the
tmpfs, and a reply written past a full one would fault.

Prints ``TASM serving on <addr>`` once the socket is accepting (scripts
wait for that line or for the socket file).  SIGINT/SIGTERM shut down
cleanly: stop accepting, drain in-flight scans, flush the tuner and
manifests, exit 0.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tasm_serve",
                                 description=__doc__.splitlines()[0])
    where = ap.add_mutually_exclusive_group(required=True)
    where.add_argument("--socket", metavar="PATH",
                       help="unix-domain socket path to listen on")
    where.add_argument("--tcp", metavar="HOST:PORT",
                       help="TCP address to listen on (PORT 0 = ephemeral)")
    ap.add_argument("--store-root", default=None,
                    help="durable store root (omit for an in-memory store)")
    # --cache-*: one flag per CacheConfig field (core/config.py)
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="decoded-tile cache budget (default: "
                         "$REPRO_CACHE_BYTES, else 256 MiB; 0 disables)")
    ap.add_argument("--tile-cache-bytes", type=int, default=None,
                    help=argparse.SUPPRESS)  # deprecated: --cache-bytes
    ap.add_argument("--cache-eviction", default=None,
                    choices=("reuse", "lru"),
                    help="eviction policy: expected-reuse weighting, or "
                         "the legacy pure LRU (default: "
                         "$REPRO_CACHE_EVICTION, else reuse)")
    ap.add_argument("--cache-prefetch", action="store_true",
                    help="predictively decode the next SOTs of detected "
                         "sliding-window scans (off by default)")
    ap.add_argument("--cache-prefetch-depth", type=int, default=2,
                    help="how many SOTs ahead to prefetch (default 2)")
    ap.add_argument("--no-cache-block-packed", dest="cache_block_packed",
                    action="store_false", default=True,
                    help="store ROI cache entries as zero-padded full-tile "
                         "canvases instead of packed blocks")
    ap.add_argument("--tuning", default="background",
                    choices=("background", "inline", "off"))
    ap.add_argument("--tuner-admission", default="policy",
                    choices=("policy", "gated"),
                    help="background tuner admission: apply every policy "
                         "proposal, or gate + rank by what-if net benefit")
    ap.add_argument("--max-frame-mb", type=int, default=None,
                    help="reject wire frames larger than this many MiB "
                         "(default 256)")
    ap.add_argument("--codec", default=None, choices=("msgpack", "json"),
                    help="wire codec for responses (default: msgpack when "
                         "installed, else json; $REPRO_TORCH_WIRE "
                         "overrides)")
    ap.add_argument("--transport", default=None,
                    choices=("shm", "socket", "auto"),
                    help="scan-reply transport: shm = require the "
                         "zero-copy shared-memory path, socket = npz "
                         "payloads only, auto = offer shm to clients "
                         "that prove they share /dev/shm (default: "
                         "$REPRO_TORCH_TRANSPORT, else auto)")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="micro-batch cap of the shared serving session")
    ap.add_argument("--decode-backend", default=None,
                    choices=("batched", "numpy"),
                    help="decode_tiles implementation: fused CUDA-kernel "
                         "batches on --device, or the per-tile numpy loop "
                         "(default: $REPRO_TORCH_DECODE_BACKEND, else "
                         "batched)")
    ap.add_argument("--device", default="cuda",
                    help="device of the store's decode and encode: cuda "
                         "(default; refuses to start without a CUDA "
                         "device), cuda:N, or cpu")
    return ap.parse_args(argv)


def shm_pool_bytes(path: str) -> int:
    """The shared-memory reply pool's cap: half the free space of the
    tmpfs at ``path``, at most the pool's default."""
    from repro_torch.core.shm import DEFAULT_POOL_BYTES

    st = os.statvfs(path)
    return min(DEFAULT_POOL_BYTES, st.f_bavail * st.f_frsize // 2)


def main(argv=None) -> int:
    args = parse_args(argv)
    from repro_torch.core import (CacheConfig, DecodeConfig, TuningConfig,
                                  VideoStore, VideoStoreServer, wire)
    kw: dict = {}
    if args.socket:
        kw["path"] = args.socket
    else:
        host, _, port = args.tcp.rpartition(":")
        kw["host"], kw["port"] = host or "127.0.0.1", int(port)
    if args.max_frame_mb is not None:
        kw["max_frame_bytes"] = args.max_frame_mb << 20
    if os.path.isdir("/dev/shm"):
        kw["shm_max_bytes"] = shm_pool_bytes("/dev/shm")
    cache_bytes = args.cache_bytes if args.cache_bytes is not None \
        else args.tile_cache_bytes
    try:
        store = VideoStore(
            store_root=args.store_root,
            cache=CacheConfig(budget_bytes=cache_bytes,
                              eviction=args.cache_eviction,
                              prefetch=args.cache_prefetch,
                              prefetch_depth=args.cache_prefetch_depth,
                              block_packed=args.cache_block_packed),
            tuning=TuningConfig(mode=args.tuning,
                                admission=args.tuner_admission),
            decode=DecodeConfig(backend=args.decode_backend,
                                device=args.device))
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"tasm_serve: {e}", file=sys.stderr, flush=True)
        return 1
    server = VideoStoreServer(store, codec=args.codec,
                              max_batch=args.max_batch,
                              transport=args.transport, **kw)
    server.start()

    def _shutdown(signum, frame):
        server.stop()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    print(f"TASM serving on {server.address} "
          f"(pid {os.getpid()}, codec {args.codec or wire.default_codec()}, "
          f"transport {server.transport}, "
          f"device {store.decode_config.device}, "
          f"store {args.store_root or '<memory>'})", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
