"""Serve a cluster of TASM nodes of the PyTorch/CUDA port behind one router
socket — or administer a running router (repair / rebalance / status).

Serve::

    PYTHONPATH=src python -m repro_torch.tasm_router \
        --socket /tmp/router.sock \
        --node a=/tmp/node-a.sock --node b=/tmp/node-b.sock \
        --node c=10.0.0.7:7841 --replication 2 \
        --placement /data/tasm/placement.json --timeout 30 \
        --health-interval 5

Each ``--node name=addr`` names one running ``python -m
repro_torch.tasm_serve`` node (Unix socket path or ``host:port``).  The
router presents the exact same wire protocol as a single node — clients
connect with :class:`repro_torch.core.ClusterClient` (or plain
``RemoteVideoStore``) and get the full declarative surface, routed: scans
go to the video's replicas (consistent-hash placement, persisted to
``--placement`` so restarts and membership changes never silently re-home
data), ``execute_many`` batches fan out per node, and mutations write
every replica.  With
``--replication K`` the cluster keeps serving a video's reads after K-1
of its nodes die.  ``--timeout`` puts a per-RPC deadline on every node
call (a hung node fails over instead of blocking a serving thread);
``--health-interval`` starts the background health loop that revives
recovered nodes automatically.

The router does no device work and takes no ``--device``: it holds no
store, never touches a tensor and never creates a CUDA context.  Each
node's store decodes and encodes on the node's own ``--device``, so
several node processes may share one card.

Administer (point ``--socket``/``--tcp`` at a RUNNING router; ``R`` is
``python -m repro_torch.tasm_router --socket /tmp/router.sock``)::

    R --repair node=b
    R --repair video=cam3
    R --repair                        # heal all
    R --rebalance                     # plan only
    R --rebalance --apply
    R --join-node d=/tmp/node-d.sock
    R --repair-status

``--repair``/``--rebalance --apply`` enqueue background copy jobs and then
wait for them (``--wait SECONDS`` bounds the wait; ``--no-wait`` returns
immediately).  Exit status 0 iff every job completed; per-job
chunks/bytes/retries are printed either way.

Prints ``TASM router serving on <addr>`` once accepting.  SIGINT/SIGTERM
shut down cleanly (drain in-flight scans, close node channels, exit 0).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys


def parse_nodes(specs) -> dict:
    nodes = {}
    for spec in specs:
        name, sep, addr = spec.partition("=")
        if not sep or not name or not addr:
            raise SystemExit(f"--node wants NAME=ADDR, got {spec!r}")
        if name in nodes:
            raise SystemExit(f"duplicate node name {name!r}")
        nodes[name] = addr
    return nodes


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tasm_router",
                                 description=__doc__.splitlines()[0])
    where = ap.add_mutually_exclusive_group(required=True)
    where.add_argument("--socket", metavar="PATH",
                       help="unix-domain socket path (listen on it when "
                            "serving; connect to it in admin modes)")
    where.add_argument("--tcp", metavar="HOST:PORT",
                       help="TCP address (PORT 0 = ephemeral when serving)")
    ap.add_argument("--node", action="append", metavar="NAME=ADDR",
                    help="a cluster node: unix socket path or host:port "
                         "(repeat per node; serve mode only)")
    ap.add_argument("--replication", type=int, default=1, metavar="K",
                    help="replicas per video (default 1; capped at the "
                         "node count)")
    ap.add_argument("--placement", default=None, metavar="FILE",
                    help="persisted placement map (loaded when it exists, "
                         "written on every assignment)")
    ap.add_argument("--max-frame-mb", type=int, default=None,
                    help="reject wire frames larger than this many MiB "
                         "(default 256)")
    ap.add_argument("--codec", default=None, choices=("msgpack", "json"),
                    help="wire codec (default: msgpack when installed, "
                         "else json; $REPRO_TORCH_WIRE overrides)")
    ap.add_argument("--node-retries", type=int, default=1,
                    help="per-channel reconnect retries for idempotent "
                         "node RPCs (default 1)")
    ap.add_argument("--timeout", type=float, default=None, metavar="S",
                    help="per-RPC deadline on node calls: a hung node "
                         "raises and fails over (default: none)")
    ap.add_argument("--health-interval", type=float, default=None,
                    metavar="S",
                    help="probe nodes about this often in the background "
                         "so recovered nodes rejoin (default: off — "
                         "revival happens on explicit node_health)")
    adm = ap.add_argument_group("admin modes (against a running router)")
    adm.add_argument("--repair", nargs="?", const="", default=None,
                     metavar="video=V|node=N",
                     help="re-replicate: one video, everything a lost "
                          "node held, or (no value) every "
                          "under-replicated video")
    adm.add_argument("--rebalance", action="store_true",
                     help="print the placement moves a rebalance would "
                          "make (add --apply to stream them)")
    adm.add_argument("--apply", action="store_true",
                     help="with --rebalance: actually move the data")
    adm.add_argument("--join-node", metavar="NAME=ADDR", default=None,
                     help="register a (fresh) node with the router")
    adm.add_argument("--repair-status", action="store_true",
                     help="print per-job progress + worker totals as JSON")
    adm.add_argument("--show-config", action="store_true",
                     help="print each node's resolved cache/tuning/decode "
                          "configuration as JSON (see core/config.py)")
    adm.add_argument("--wait", type=float, default=None, metavar="S",
                     help="admin: bound the wait for enqueued jobs "
                          "(default: wait until they settle)")
    adm.add_argument("--no-wait", action="store_true",
                     help="admin: enqueue and exit without waiting")
    args = ap.parse_args(argv)
    args.admin = (args.repair is not None or args.rebalance
                  or args.repair_status or args.join_node is not None
                  or args.show_config)
    if args.admin and args.node:
        ap.error("--node is for serve mode; admin modes talk to a "
                 "running router")
    if not args.admin and not args.node:
        ap.error("serve mode needs at least one --node NAME=ADDR")
    return args


def _addr_kwargs(args) -> dict:
    if args.socket:
        return {"path": args.socket}
    host, _, port = args.tcp.rpartition(":")
    return {"host": host or "127.0.0.1", "port": int(port)}


def _print_jobs(jobs) -> None:
    for j in jobs:
        line = (f"  [{j['job_id']}] {j['kind']} {j['video']}: "
                f"{j['src'] or '?'} -> {j['dst']}  {j['status']}  "
                f"chunks {j['chunks_done']}/{j['chunks_total']}  "
                f"{j['bytes_copied'] / 1e6:.2f} MB  "
                f"retries {j['retries']}  restreams {j['restreams']}")
        if j["error"]:
            line += f"  error: {j['error']}"
        print(line, flush=True)


def admin(args) -> int:
    from repro_torch.core import ClusterClient
    with ClusterClient(**_addr_kwargs(args), codec=args.codec) as c:
        if args.repair_status:
            print(json.dumps(c.repair_status(), indent=1, sort_keys=True))
            return 0
        if args.show_config:
            doc = c.config()

            def as_doc(d):
                return {k: v.to_doc() for k, v in d.items()}

            out = {"nodes": {n: None if d is None else as_doc(d)
                             for n, d in doc["nodes"].items()}} \
                if "nodes" in doc else as_doc(doc)
            print(json.dumps(out, indent=1, sort_keys=True))
            return 0
        if args.join_node is not None:
            (name, addr), = parse_nodes([args.join_node]).items()
            out = c.join_node(name, addr)
            print(f"joined {name} ({'alive' if out['alive'] else 'DOWN'}); "
                  f"nodes: {out['nodes']}", flush=True)
            if not (args.repair is not None or args.rebalance):
                return 0
        enqueued = []
        if args.repair is not None:
            target: dict = {}
            if args.repair:
                k, sep, v = args.repair.partition("=")
                if not sep or k not in ("video", "node"):
                    raise SystemExit(
                        f"--repair wants video=V or node=N, "
                        f"got {args.repair!r}")
                target[k] = v
            enqueued = c.repair(**target)
            print(f"repair: {len(enqueued)} copy job(s) enqueued",
                  flush=True)
        if args.rebalance:
            doc = c.rebalance(apply=args.apply)
            for v, (cur, new) in sorted(doc["moves"].items()):
                print(f"  move {v}: {cur} -> {new}", flush=True)
            if not doc["moves"]:
                print("rebalance: nothing to move", flush=True)
            if not args.apply:
                return 0
            enqueued += doc["jobs"]
            flipped = doc.get("flipped") or []
            if flipped:
                print(f"rebalance: flipped in place: {flipped}",
                      flush=True)
            print(f"rebalance: {len(doc['jobs'])} copy job(s) enqueued",
                  flush=True)
        _print_jobs(enqueued)
        if args.no_wait or not enqueued:
            return 0
        ids = {j["job_id"] for j in enqueued}
        note = None
        try:
            status = c.drain_repair(timeout=args.wait)
        except Exception as e:  # noqa: BLE001 - job failure or timeout
            # drain re-raises the most recent job failure — which may be
            # an EARLIER round's job this retry just healed around.  The
            # verdict is the fate of the jobs WE enqueued.
            note = e
            status = c.repair_status()
        mine = [j for j in status["jobs"] if j["job_id"] in ids]
        _print_jobs(mine)
        if all(j["status"] == "done" for j in mine):
            if note is not None:
                print(f"note: an earlier repair attempt had failed "
                      f"({note}); this one completed", flush=True)
            return 0
        print(f"repair did not settle cleanly"
              + (f": {note}" if note else ""), file=sys.stderr, flush=True)
        return 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.admin:
        return admin(args)
    from repro_torch.core import ClusterRouter, ClusterRouterServer, wire
    kw: dict = _addr_kwargs(args)
    rkw: dict = {}
    if args.max_frame_mb is not None:
        rkw["max_frame_bytes"] = kw["max_frame_bytes"] = \
            args.max_frame_mb << 20
    router = ClusterRouter(parse_nodes(args.node),
                           replication=args.replication,
                           placement_path=args.placement,
                           codec=args.codec, node_retries=args.node_retries,
                           timeout=args.timeout,
                           health_interval=args.health_interval,
                           **rkw)
    server = ClusterRouterServer(router, codec=args.codec, **kw)
    server.start()

    def _shutdown(signum, frame):
        server.stop()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    down = sorted(router._down)
    print(f"TASM router serving on {server.address} "
          f"(pid {os.getpid()}, codec {args.codec or wire.default_codec()}, "
          f"nodes {sorted(router.addresses)}, replication "
          f"{router.placement.replication}"
          + (f", DOWN {down}" if down else "") + ")", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
