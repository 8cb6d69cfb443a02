#!/usr/bin/env python
"""Cluster smoke of the PyTorch/CUDA port: the drill of
``scripts/cluster_smoke.py`` on ``repro_torch``.  3 ``python -m
repro_torch.tasm_serve`` nodes behind one ``python -m
repro_torch.tasm_router``, two concurrent client PROCESSES, and a node
killed mid-workload.  Asserts the distributed-serving contract end to end,
across real process boundaries:

- both clients' results are bit-identical to an in-process ``execute()``
  of the same scans on an identically-built local store;
- with ``--replication 2``, SIGKILLing one node while a client is
  mid-workload loses NO reads — every remaining iteration still returns
  bit-identical results (the router fails reads over to the surviving
  replica);
- the router reports the killed node down, and SIGTERM shuts router and
  nodes down cleanly (exit 0, socket files gone);
- self-healing: after a foreground retile, a fresh disk-backed node joins
  (``tasm_router --join-node``), ``--repair node=<dead>`` restores
  K=2 — with the destination SIGKILLed mid-copy and restarted, the
  retried repair resumes from staged chunks, a client iterating
  throughout loses zero reads, every wave stays bit-identical, and the
  rebuilt replica serves the post-retile epoch (never the stale
  generation).

Exits non-zero on any violation::

    python scripts/cluster_smoke_torch.py
    python scripts/cluster_smoke_torch.py --device cpu

``--device`` (``cuda`` by default) is passed to every node, whose stores
decode and encode there, and names the local reference store's device;
the router takes none and holds no CUDA context.  Without a CUDA device
and without ``--device cpu`` the script exits 1.

``--faults`` additionally wires the fresh node through the byte-level
fault proxy (``tests/faults.py``) — the repair stream gets a mid-stream
disconnect, a torn frame, and slow-link delays injected, and must still
converge.

The script doubles as its own client: ``cluster_smoke_torch.py --client
SOCK OUT [ITERS SLEEP]`` connects to the router, runs the canonical workload
``ITERS`` times (sleeping ``SLEEP`` seconds between iterations), and
writes results to ``OUT.npz`` + ``OUT.json`` for the parent to compare.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402

from repro_torch.codec.encode import EncoderConfig  # noqa: E402
from repro_torch.core import (ClusterClient, DecodeConfig,  # noqa: E402
                              NoTilingPolicy, RemoteVideoStore, VideoStore,
                              uniform_layout)
from repro_torch.data.video_gen import generate, sparse_spec  # noqa: E402

ENC = EncoderConfig(gop=16, qp=8)
N_FRAMES, H, W = 32, 96, 160
VIDEOS = ["cam0", "cam1", "cam2", "cam3"]
#: the canonical workload: per-video windows over two labels
WORKLOAD = [(v, label, rng) for v in VIDEOS
            for label, rng in (("car", (0, 32)), ("person", (8, 24)))]
#: seconds for a process of the port to start (a torch import, and a CUDA
#: context for a node)
START_S = 180


def corpus():
    return {v: generate(sparse_spec(seed=i, n_frames=N_FRAMES, height=H,
                                    width=W))
            for i, v in enumerate(VIDEOS)}


def run_workload(store):
    return [store.scan(v).labels(label).frames(*rng).execute()
            for v, label, rng in WORKLOAD]


# --------------------------------------------------------------- client
def client_main(sock_path: str, out: str, iters: str = "1",
                sleep_s: str = "0") -> int:
    with ClusterClient(sock_path) as cli:
        waves = []
        for _ in range(int(iters)):
            waves.append(run_workload(cli))
            # progress for the parent, which times its kills by waves (a
            # client of the port spends seconds importing torch first)
            pathlib.Path(out + ".waves").write_text(str(len(waves)))
            time.sleep(float(sleep_s))
    arrays, meta = {}, []
    for w, results in enumerate(waves):
        wave_meta = []
        for i, r in enumerate(results):
            regs = []
            for j, (f, box, px) in enumerate(r.regions):
                arrays[f"px_{w}_{i}_{j}"] = px
                regs.append([f, list(box)])
            wave_meta.append(regs)
        meta.append(wave_meta)
    np.savez(out + ".npz", **arrays)
    pathlib.Path(out + ".json").write_text(json.dumps(meta))
    return 0


def load_client(out: str):
    meta = json.loads(pathlib.Path(out + ".json").read_text())
    npz = np.load(out + ".npz")
    return [[[(f, tuple(box), npz[f"px_{w}_{i}_{j}"])
              for j, (f, box) in enumerate(regs)]
             for i, regs in enumerate(wave)]
            for w, wave in enumerate(meta)]


def assert_same_regions(a, b, where: str) -> None:
    assert len(a) == len(b), f"{where}: {len(a)} vs {len(b)} regions"
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1], f"{where}: region keys diverge"
        if not np.array_equal(ra[-1], rb[-1]):
            raise AssertionError(f"{where}: pixels not bit-identical at "
                                 f"frame {ra[0]}")


def assert_wave_matches(wave, reference, where: str) -> None:
    assert len(wave) == len(reference), f"{where}: workload length"
    for q, (got, ref) in enumerate(zip(wave, reference)):
        assert_same_regions(ref.regions, got, f"{where} query {q}")


# --------------------------------------------------------------- parent
def port_env() -> dict:
    """This checkout's ``src`` first on the children's ``PYTHONPATH``."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))


def wait_for_socket(path: str, proc, timeout: float = START_S) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server died early (rc={proc.returncode})")
        if os.path.exists(path):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(path)
                return
            except OSError:
                pass
            finally:
                s.close()
        time.sleep(0.05)
    raise RuntimeError(f"socket {path} never came up")


def wait_for_waves(out: str, proc, n: int, timeout: float = START_S) -> None:
    """Block until the client writing ``out`` has finished ``n`` waves."""
    deadline = time.time() + timeout
    path = pathlib.Path(out + ".waves")
    while time.time() < deadline:
        if path.exists() and int(path.read_text() or 0) >= n:
            return
        if proc.poll() is not None:
            raise RuntimeError(f"client exited early (rc={proc.returncode})")
        time.sleep(0.05)
    raise RuntimeError(f"client never finished {n} waves")


def client(router_sock: str, out: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--client", router_sock, out, *args],
                            env=port_env())


def node(sock: str, device: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "repro_torch.tasm_serve",
                             "--socket", sock, "--device", device, *args],
                            env=port_env())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--client":
        return client_main(*argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    ap.add_argument("--faults", action="store_true",
                    help="wire the fresh node through the fault proxy")
    args = ap.parse_args(argv)
    try:
        DecodeConfig(device=args.device).resolve()
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"cluster_smoke_torch: {e}", file=sys.stderr)
        return 1
    faults_mode, device = args.faults, args.device

    tmp = tempfile.mkdtemp(prefix="tasm_cluster_smoke_")
    here = os.path.dirname(os.path.abspath(__file__))
    node_socks = [os.path.join(tmp, f"n{i}.sock") for i in range(3)]
    router_sock = os.path.join(tmp, "router.sock")
    nodes = [node(sock, device) for sock in node_socks]
    router = None
    proxy = None
    try:
        for sock, proc in zip(node_socks, nodes):
            wait_for_socket(sock, proc)
        router = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.tasm_router",
             "--socket", router_sock, "--replication", "2",
             "--placement", os.path.join(tmp, "placement.json"),
             "--timeout", "15", "--health-interval", "0.5"]
            + [a for i, sock in enumerate(node_socks)
               for a in ("--node", f"n{i}={sock}")], env=port_env())
        wait_for_socket(router_sock, router)
        videos = corpus()

        # seed the cluster through the router, and build the in-process
        # reference store identically (encode is deterministic)
        local = VideoStore(decode=DecodeConfig(device=device))
        with ClusterClient(router_sock) as seed:
            for name, (frames, dets) in videos.items():
                for store in (seed, local):
                    store.add_video(name, encoder=ENC,
                                    policy=NoTilingPolicy())
                    store.ingest(name, frames)
                    store.add_detections(name,
                                         {f: d for f, d in enumerate(dets)})
            placement = seed.placement()["assignments"]
        reference = run_workload(local)  # local stays open: the
        # self-healing phase retiles both sides and re-derives it

        # two concurrent client processes over one router
        outs = [os.path.join(tmp, f"client{i}") for i in (1, 2)]
        clients = [client(router_sock, out) for out in outs]
        rcs = [c.wait(timeout=300) for c in clients]
        assert rcs == [0, 0], f"client exit codes {rcs}"
        got = [load_client(out)[0] for out in outs]
        assert_wave_matches(got[0], reference, "client1 vs local")
        assert_wave_matches(got[1], reference, "client2 vs local")
        print(f"# two concurrent clients bit-identical to in-process "
              f"execute on {device} ({sum(len(r) for r in got[0])} "
              f"regions)", flush=True)

        # kill cam0's PRIMARY mid-workload: a third client iterates the
        # workload; with K=2 every video keeps a live replica, so every
        # wave — before, during, and after the kill — must stay
        # bit-identical
        victim = int(placement["cam0"][0][1:])  # "n2" -> index 2
        out3 = os.path.join(tmp, "client3")
        killer = client(router_sock, out3, "6", "0.2")
        wait_for_waves(out3, killer, 2)  # a couple of waves in
        nodes[victim].send_signal(signal.SIGKILL)
        nodes[victim].wait(timeout=30)
        rc = killer.wait(timeout=300)
        assert rc == 0, f"mid-kill client exit code {rc}"
        waves = load_client(out3)
        assert len(waves) == 6
        for w, wave in enumerate(waves):
            assert_wave_matches(wave, reference,
                                f"wave {w} (node n{victim} killed)")
        with ClusterClient(router_sock) as probe:
            health = probe.node_health()
            assert health[f"n{victim}"] is False, health
            assert sum(1 for ok in health.values() if ok) == 2, health
        print(f"# killed n{victim} mid-workload: 6/6 waves bit-identical, "
              f"router reports it down", flush=True)

        # ---- self-healing: fresh node joins, repair restores K=2 ----
        # retile cam0 first so the rebuilt replica must prove it serves
        # the POST-retile generation, never the stale one
        with ClusterClient(router_sock) as adm:
            adm.retile("cam0", 0, uniform_layout(H, W, 2, 2))
        local.retile("cam0", 0, uniform_layout(H, W, 2, 2))
        reference = run_workload(local)
        local.close()

        n3_sock = os.path.join(tmp, "n3.sock")
        n3_root = os.path.join(tmp, "store-n3")  # disk-backed: staged
        # chunks must survive the destination SIGKILL below

        def start_n3():
            p = node(n3_sock, device, "--store-root", n3_root)
            wait_for_socket(n3_sock, p)
            return p

        n3 = start_n3()
        nodes.append(n3)
        n3_addr = n3_sock
        if faults_mode:
            sys.path.insert(0, os.path.join(here, "..", "tests"))
            from faults import Fault, FaultProxy
            proxy = FaultProxy(n3_sock, faults=[
                Fault(cut_after=20000),                   # mid-stream cut
                Fault(corrupt_at=4000, direction="c2b"),  # torn frame
                Fault(delay_s=0.05), Fault(delay_s=0.05),  # slow link
            ])
            n3_addr = proxy.address
            print("# fault proxy armed in front of n3 "
                  "(cut, torn frame, delays)")

        def router_admin(*argv, check=True, timeout=300):
            rc = subprocess.call(
                [sys.executable, "-m", "repro_torch.tasm_router",
                 "--socket", router_sock, *argv], timeout=timeout,
                env=port_env())
            if check:
                assert rc == 0, f"tasm_router {argv} exit code {rc}"
            return rc

        router_admin("--join-node", f"n3={n3_addr}")

        # a client iterates THROUGHOUT the repair: zero failed reads
        out4 = os.path.join(tmp, "client4")
        during = client(router_sock, out4, "6", "0.3")
        wait_for_waves(out4, during, 1)

        # enqueue the repair, then SIGKILL the destination mid-copy: no
        # torn state may survive, and a retried repair must complete
        router_admin("--repair", f"node=n{victim}", "--no-wait")
        time.sleep(0.2 if faults_mode else 0.05)
        n3.send_signal(signal.SIGKILL)
        n3.wait(timeout=30)
        nodes.remove(n3)
        n3 = start_n3()
        nodes.append(n3)
        print("# destination SIGKILLed mid-copy and restarted")
        # the health loop marked n3 down when it died; make sure the
        # router sees it alive again before retrying, so the retried
        # copy resumes onto n3's staged chunks rather than re-homing
        with ClusterClient(router_sock) as probe:
            deadline = time.time() + 30
            while time.time() < deadline:
                if probe.node_health().get("n3"):
                    break
                time.sleep(0.2)
            else:
                raise RuntimeError("restarted n3 never came back up")
        router_admin("--repair", f"node=n{victim}", "--wait", "240")

        rc = during.wait(timeout=300)
        assert rc == 0, f"during-repair client exit code {rc}"
        for w, wave in enumerate(load_client(out4)):
            assert_wave_matches(wave, reference,
                                f"during-repair wave {w}")
        print("# zero failed reads during repair: 6/6 waves bit-identical")

        with ClusterClient(router_sock) as probe:
            placement = probe.placement()["assignments"]
            for v, reps in placement.items():
                assert f"n{victim}" not in reps, (v, reps)
                assert len(reps) == 2, (v, reps)
            final = run_workload(probe)
            assert_wave_matches([r.regions for r in final], reference,
                                "post-repair router read")
        # the rebuilt replica serves the post-retile generation: read it
        # DIRECTLY (bypassing the router) and check bits + epoch table
        with RemoteVideoStore(n3_sock) as direct:
            n3_videos = [v for v, reps in placement.items()
                         if "n3" in reps]
            assert n3_videos, f"repair never placed anything on n3: " \
                              f"{placement}"
            if "cam0" in n3_videos:
                assert direct.epochs("cam0")[0] >= 1, \
                    "rebuilt replica still on the pre-retile epoch"
            for v, label, rng in WORKLOAD:
                if v not in n3_videos:
                    continue
                got = direct.scan(v).labels(label).frames(*rng).execute()
                i = WORKLOAD.index((v, label, rng))
                assert_same_regions(reference[i].regions, got.regions,
                                    f"n3 direct {v}")
        print(f"# repair restored K=2 onto n3 ({sorted(n3_videos)}); "
              f"rebuilt replica bit-identical, post-retile epoch")
        if proxy is not None:
            assert proxy.faults_fired >= 1, "faults never hit the stream"
            print(f"# chaos: {proxy.faults_fired} fault(s) injected into "
                  f"the copy path, repair converged anyway")

        # clean shutdown: SIGTERM -> exit 0, sockets unlinked
        router.send_signal(signal.SIGTERM)
        rc = router.wait(timeout=60)
        assert rc == 0, f"router exit code {rc}"
        assert not os.path.exists(router_sock), "router socket left behind"
        for i, proc in enumerate(nodes):
            if i == victim:
                continue
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            assert rc == 0, f"node n{i} exit code {rc}"
        print("# clean shutdown: router and surviving nodes exit 0")
        print("cluster_smoke_torch,0.0,ok")
        return 0
    finally:
        if proxy is not None:
            proxy.close()
        for proc in ([router] if router else []) + nodes:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


if __name__ == "__main__":
    raise SystemExit(main())
