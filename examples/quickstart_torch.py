"""Quickstart on the PyTorch/CUDA port: the flow of
``examples/quickstart.py`` on ``repro_torch``.  Ingest a camera feed into
the VideoStore engine, run declarative scan queries, watch the storage
manager adapt its tile layout (paper §1's amber-alert flow), reopen the
catalog from its manifest, and serve the store over a socket, from a
cluster of nodes and through shared memory.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``--device`` is ``cuda`` by default (every store's decode and encode, and
the cost model's calibration): the ingest and the retiles encode with the
``dct_quant`` and ``idct_dequant`` kernels and the scans decode with
``decode_gop_blocks``.  The script exits 1 without a CUDA device, and
exits 1 if a contract it prints does not hold.  :func:`run` is the whole
flow, importable as it is; it returns the contracts by name.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (CacheConfig, ClusterClient, ClusterRouter,
                              ClusterRouterServer, DecodeConfig,
                              NoTilingPolicy, RegretPolicy, RemoteVideoStore,
                              VideoStore, VideoStoreServer)
from repro_torch.core.calibrate import calibrated_cost_model
from repro_torch.core.shm import shm_available
from repro_torch.data.video_gen import generate, sparse_spec

ATOL, RTOL = 1e-3, 1e-5


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        ra[:-1] == rb[:-1] and np.array_equal(ra[-1], rb[-1])
        for ra, rb in zip(a, b))


def run(root: str, device: str = "cuda") -> dict:
    """The quickstart under ``root`` with every store on ``device``;
    returns its contracts (each should be True) by name."""
    decode = DecodeConfig(device=device)
    ok = {}
    # 1. a "camera feed": procedural traffic video with ground-truth
    #    detections
    spec = sparse_spec(seed=0, n_frames=128, height=192, width=320)
    frames, detections = generate(spec)
    print(f"video: {frames.shape}, objects: "
          f"{sorted({l for d in detections for l, _ in d})}")

    # 2. a VideoStore catalog backed by disk, with the regret-based
    #    incremental tiling policy (§4.4) for this camera
    model = calibrated_cost_model(EncoderConfig(), seeds=(0,), repeats=1,
                                  device=device)
    store = VideoStore(store_root=root, decode=decode)
    store.add_video("traffic", encoder=EncoderConfig(gop=16, qp=8),
                    policy=RegretPolicy(), cost_model=model)
    store.ingest("traffic", frames)
    print(f"ingested untiled on {store.decode_config.device}: "
          f"{store.storage_bytes('traffic') / 1e3:.0f} KB "
          f"-> catalog at {store.catalog_path}")

    # 3. the query processor detects objects as a byproduct of queries and
    #    feeds the semantic index via ADDMETADATA
    for f, dets in enumerate(detections):
        for label, (y1, x1, y2, x2) in dets:
            store.add_metadata("traffic", f, label, x1, y1, x2, y2)
    print("semantic index:", store.video("traffic").index.stats())

    # 4. plan/execute split: EXPLAIN shows the SOTs/tiles the engine would
    #    decode, with estimated cost from the what-if interface — no
    #    decoding
    query = store.scan("traffic").labels("car").frames(0, 64)
    print("\n" + query.explain().describe() + "\n")

    # 5. ROI-restricted block decode (the default): a subframe scan decodes
    #    only the 8x8 blocks its boxes intersect.  Toggle it off to see what
    #    the same query costs under full-tile decode — results are
    #    bit-identical
    store.roi_decode = False
    full = query.execute()
    store.tile_cache.clear()   # cold again, so the ROI run really decodes
    store.roi_decode = True
    roi = query.execute()
    full_px, roi_px = full.stats.pixels_decoded, roi.stats.pixels_decoded
    ok["roi_bit_identical"] = _same(full.regions, roi.regions)
    print(f"pixels decoded, full-tile {full_px / 1e6:.2f} M -> "
          f"ROI {roi_px / 1e6:.2f} M ({full_px / max(roi_px, 1):.1f}x "
          f"fewer), bit-identical: {ok['roi_bit_identical']}")

    # 5b. the numpy oracle backend: DecodeConfig(backend="numpy") decodes
    #     tile by tile with the numpy decode_tile; the default "batched"
    #     backend flattens every (tile, GOP, block-mask) selection of a
    #     group fetch into one dispatch of the fused decode kernel on the
    #     store's device.  They agree within the oracle's tolerance (the
    #     kernel sums in another order than numpy's einsum)
    oracle = VideoStore(decode=DecodeConfig(backend="numpy", device=device))
    oracle.add_video("traffic", encoder=EncoderConfig(gop=16, qp=8))
    oracle.ingest("traffic", frames)
    oracle.add_detections("traffic",
                          {f: d for f, d in enumerate(detections)})
    r_numpy = oracle.scan("traffic").labels("car").frames(0, 64).execute()
    r_batched = query.execute()
    err = max((float(np.abs(a[-1] - b[-1]).max(initial=0.0))
               for a, b in zip(r_numpy.regions, r_batched.regions)),
              default=0.0)
    ok["batched_within_oracle"] = len(r_numpy.regions) == len(
        r_batched.regions) and all(
        a[:-1] == b[:-1] and np.allclose(b[-1], a[-1], atol=ATOL, rtol=RTOL)
        for a, b in zip(r_numpy.regions, r_batched.regions))
    print(f"numpy oracle backend: {len(r_numpy.regions)} regions, batched "
          f"within atol={ATOL}, rtol={RTOL}: {ok['batched_within_oracle']} "
          f"(max |diff| {err:.3g})")
    oracle.close()

    # 6. run repeated declarative queries; the layout evolves under the
    #    policy and the tile cache absorbs repeat decodes (epoch bumps
    #    invalidate it).  Tuning runs in the BACKGROUND by default: queries
    #    only emit workload observations, the tuner thread re-tiles off the
    #    critical path, so retile stays 0.0 ms for every query
    charged = 0
    for i in range(14):
        s = query.execute().stats
        charged += s.retile_s > 0
        print(f"q{i}: decode={s.decode_s * 1e3:6.1f} ms  "
              f"pixels={s.pixels_decoded / 1e6:5.2f} M  "
              f"tiles={s.tiles_decoded:3.0f}"
              f"  cache={s.cache_hits}h/{s.cache_misses}m"
              f"  retile={s.retile_s * 1e3:6.1f} ms")
    ok["no_query_charged_retile"] = charged == 0

    ts = store.drain_tuner()  # barrier: wait for background tuning
    print(f"tuner: {ts.observed} observations -> {ts.applied} retiles "
          f"applied, {ts.retile_s * 1e3:.0f} ms re-encode paid off the "
          f"scan path")
    print("final layouts:",
          [r.layout.describe() for r in store.video("traffic").store.sots])
    print("\nafter adaptation:\n" + query.explain().describe())

    # 6b. workload-predictive tile cache: with prefetch on, after three
    #     windows of a sliding scan the cache recognizes the monotone SOT
    #     progression and decodes the NEXT SOTs on the worker pool before
    #     they are asked for — later windows then decode zero tiles
    pred = VideoStore(cache=CacheConfig(prefetch=True, prefetch_depth=2),
                      decode=decode)
    pred.add_video("traffic", encoder=EncoderConfig(gop=16, qp=8),
                   sot_len=16)
    pred.ingest("traffic", frames)
    pred.add_detections("traffic", {f: d for f, d in enumerate(detections)})
    print()
    for i in range(8):
        s = pred.scan("traffic").labels("car") \
                .frames(i * 16, (i + 1) * 16).execute().stats
        pred.drain_prefetch()  # barrier: the demo stays deterministic
        print(f"window {i}: pixels={s.pixels_decoded / 1e6:5.2f} M  "
              f"cache={s.cache_hits}h/{s.cache_misses}m")
    cs = pred.tile_cache.stats()
    ok["prefetch_hits"] = cs.prefetch_hits > 0
    print(f"prefetch: {cs.prefetch_issued} issued, {cs.prefetch_hits} hit, "
          f"{cs.prefetch_wasted} wasted; block packing saved "
          f"{cs.packed_bytes_saved / 1e6:.1f} MB of cache budget")
    pred.close()

    # 7. disjunctive predicate (one clause: car OR person), limited
    res = store.scan("traffic").labels("car", "person").frames(0, 32) \
               .limit(50).execute()
    print(f"\ndisjunctive query returned {len(res.regions)} regions "
          f"(limit 50)")

    # 8. verify pixels: the decoded crop matches the source (lossy codec)
    f, box, px = res.regions[0]
    y1, x1, y2, x2 = box
    err = np.abs(px - frames[f, y1:y2, x1:x2]).mean()
    ok["pixels_close_to_source"] = err < 6.0
    print(f"mean |decoded - source| = {err:.2f} (8-bit scale)")

    # 9. concurrent serving: overlapping scans submitted together merge
    #    their SOT decodes (each shared tile decoded at most once, then
    #    cached)
    with store.serve() as session:
        futs = [session.submit(store.scan("traffic").labels("car")
                               .frames(0, 64)) for _ in range(4)]
        batch = [f.result() for f in futs]
    hits = sum(r.stats.cache_hits for r in batch)
    misses = sum(r.stats.cache_misses for r in batch)
    print(f"\nserved 4 overlapping scans: {hits} cache hits, "
          f"{misses} fresh tile decodes")

    # 10. reopen the catalog from its on-disk manifest: no re-ingest needed
    reopened = VideoStore(store_root=root, decode=decode)
    res2 = reopened.scan("traffic").labels("car").frames(0, 64).execute()
    ok["reopen_bit_identical"] = _same(
        store.scan("traffic").labels("car").frames(0, 64).execute().regions,
        res2.regions)
    print(f"reopened {reopened.videos()} from manifest; "
          f"scan bit-identical: {ok['reopen_bit_identical']}")

    # 11. cross-process serving: expose the store over a socket and query
    #     it with RemoteVideoStore — same declarative surface, shared
    #     cache, and results bit-identical to in-process execute().  (In
    #     production the server runs via ``python -m
    #     repro_torch.tasm_serve --socket ...`` and clients are separate
    #     processes; here both ends live in this script.)
    sock = os.path.join(root, "tasm.sock")
    with VideoStoreServer(reopened, path=sock, owns_store=False).start():
        with RemoteVideoStore(sock) as remote:
            r_remote = remote.scan("traffic").labels("car").frames(0, 64) \
                             .execute()
            ok["remote_bit_identical"] = _same(res2.regions,
                                               r_remote.regions)
            print(f"\nremote scan over {remote.ping()['codec']} wire: "
                  f"{len(r_remote.regions)} regions, bit-identical: "
                  f"{ok['remote_bit_identical']}, cache hits "
                  f"{r_remote.stats.cache_hits}")

    # 12. distributed VideoStore: three nodes behind a ClusterRouter
    #     (replication=2), bit-identical to a single store, then a node
    #     killed for good and repaired onto the spare.  (In production the
    #     nodes run ``python -m repro_torch.tasm_serve`` and the router
    #     ``python -m repro_torch.tasm_router``; here all of them live in
    #     this script.)
    nodes = {f"n{i}": os.path.join(root, f"node{i}.sock") for i in range(3)}
    node_stores = {name: VideoStore(decode=decode) for name in nodes}
    node_servers = {name: VideoStoreServer(node_stores[name], path=path,
                                           owns_store=False).start()
                    for name, path in nodes.items()}
    router = ClusterRouter(nodes, replication=2,
                           placement_path=os.path.join(root,
                                                       "placement.json"))
    router.add_video("traffic", encoder=EncoderConfig(gop=16, qp=8),
                     policy=NoTilingPolicy())
    router.ingest("traffic", frames)
    router.add_detections("traffic",
                          {f: d for f, d in enumerate(detections)})
    rsock = os.path.join(root, "router.sock")
    with ClusterRouterServer(router, path=rsock, owns_store=False).start():
        with ClusterClient(rsock) as cluster:
            r_cluster = cluster.scan("traffic").labels("car") \
                               .frames(0, 64).execute()
            ref = VideoStore(decode=decode)
            ref.add_video("traffic", encoder=EncoderConfig(gop=16, qp=8),
                          policy=NoTilingPolicy())
            ref.ingest("traffic", frames)
            ref.add_detections("traffic",
                               {f: d for f, d in enumerate(detections)})
            r_single = ref.scan("traffic").labels("car").frames(0, 64) \
                          .execute()
            ok["cluster_bit_identical"] = _same(r_single.regions,
                                                r_cluster.regions)
            print(f"\ncluster of {len(nodes)} nodes (replication=2): "
                  f"{len(r_cluster.regions)} regions, bit-identical to a "
                  f"single store: {ok['cluster_bit_identical']}, placement "
                  f"{cluster.placement()['assignments']}")

            # 12b. self-healing: kill the video's primary node for good,
            #      then one repair command re-replicates everything it held
            #      onto the spare node, reads serving from the surviving
            #      replica throughout
            victim = cluster.placement()["assignments"]["traffic"][0]
            node_servers.pop(victim).stop()
            node_stores.pop(victim).close()
            r_degraded = cluster.scan("traffic").labels("car") \
                                .frames(0, 64).execute()
            jobs = cluster.repair(node=victim)
            status = cluster.drain_repair()         # wait for the copy
            r_healed = cluster.scan("traffic").labels("car") \
                              .frames(0, 64).execute()
            ok["healed_bit_identical"] = _same(r_single.regions,
                                               r_healed.regions)
            ok["failover_bit_identical"] = _same(r_single.regions,
                                                 r_degraded.regions)
            print(f"killed {victim} -> {len(r_degraded.regions)} regions "
                  f"via failover; repair streamed {len(jobs)} job(s), "
                  f"{status['stats']['chunks_copied']} chunks "
                  f"({status['stats']['bytes_copied'] / 1e6:.2f} MB); "
                  f"healed placement "
                  f"{cluster.placement()['assignments']['traffic']}, "
                  f"bit-identical: {ok['healed_bit_identical']}")
            ref.close()
    router.close()
    for srv in node_servers.values():
        srv.stop()
    for s in node_stores.values():
        s.close()

    # 13. zero-copy serving: on a same-host unix socket the server ships
    #     result arrays through POSIX shared memory ("auto" negotiates it;
    #     "socket" forces the npz fallback used for TCP/cross-host).  Both
    #     transports produce bit-identical bytes
    sock13 = os.path.join(root, "tasm13.sock")
    with VideoStoreServer(reopened, path=sock13, owns_store=False).start():
        with RemoteVideoStore(sock13) as fast, \
                RemoteVideoStore(sock13, transport="socket") as slow:
            r_shm = fast.scan("traffic").labels("car").frames(0, 64) \
                        .execute()
            r_npz = slow.scan("traffic").labels("car").frames(0, 64) \
                        .execute()
            ok["transports_bit_identical"] = _same(r_shm.regions,
                                                   r_npz.regions)
            print(f"\nzero-copy serving (shm available: "
                  f"{shm_available()}): negotiated {fast.transport!r} vs "
                  f"forced {slow.transport!r}, bit-identical: "
                  f"{ok['transports_bit_identical']}; "
                  f"{r_shm.stats.payload_bytes} payload bytes marshalled "
                  f"in {r_shm.stats.marshal_s * 1e3:.2f} ms over "
                  f"{r_shm.stats.transport}")

    reopened.close()
    store.close()
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    try:
        DecodeConfig(device=args.device).resolve()
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"quickstart_torch: {e}", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="tasm_store_") as root:
        ok = run(root, args.device)
    failed = sorted(k for k, v in ok.items() if not v)
    print(f"\ncontracts: {len(ok) - len(failed)} of {len(ok)} hold"
          + (f"; failed: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
