#!/usr/bin/env python
"""Cross-process serving smoke of the PyTorch/CUDA port: the drill of
``scripts/server_smoke.py`` on ``repro_torch``.  Start ``python -m
repro_torch.tasm_serve`` on a Unix socket, run two concurrent client
PROCESSES, and assert the serving contract — once per reply transport
(``--transport both``, the default, runs the whole smoke twice: a
``--transport shm`` server and a ``--transport socket`` one):

- both clients' results are bit-identical to an in-process ``execute()``
  of the same scans on an identically-built local store on the same
  device;
- every client negotiated the transport its server was started with
  (``shm`` server -> clients report ``shm``; ``socket`` server -> ``npz``);
- a repeat of the workload by a fresh client process decodes ZERO tiles
  (the tile cache is shared across the process boundary);
- under shm, the server's segment pool drains back to zero once the
  client processes exit (no leaked leases);
- SIGTERM shuts the server down cleanly (exit code 0, socket file gone,
  no orphaned process).

Exits non-zero on any violation::

    python scripts/server_smoke_torch.py --transport shm
    python scripts/server_smoke_torch.py --device cpu

``--device`` (``cuda`` by default) is passed to the server, whose store
decodes and encodes there, and names the local store's device; without a
CUDA device and without ``--device cpu`` the script exits 1.  The server
sizes its shared-memory pool within the free space of ``/dev/shm``.

The script doubles as its own client: ``server_smoke_torch.py --client
SOCK OUT`` connects, runs the canonical workload, and writes results to
``OUT.npz`` + ``OUT.json`` for the parent to compare.
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
from repro_torch.core import (DecodeConfig, NoTilingPolicy,  # noqa: E402
                              RemoteVideoStore, VideoStore)
from repro_torch.data.video_gen import generate, sparse_spec  # noqa: E402

ENC = EncoderConfig(gop=16, qp=8)
N_FRAMES, H, W = 48, 96, 160
#: the canonical two-client workload: overlapping windows over two labels
WORKLOAD = [("car", (0, 32)), ("person", (16, 48)), ("car", (16, 48)),
            ("car", (0, 48))]
#: client-visible transport expected per server transport flag
EXPECT = {"shm": "shm", "socket": "npz"}
#: seconds for a process of the port to start (a torch import, and a CUDA
#: context for the server)
START_S = 180


def corpus():
    return generate(sparse_spec(seed=3, n_frames=N_FRAMES, height=H,
                                width=W))


def run_workload(store):
    return [store.scan("cam0").labels(label).frames(*rng).execute()
            for label, rng in WORKLOAD]


def port_env() -> dict:
    """This checkout's ``src`` first on the children's ``PYTHONPATH``."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))


# --------------------------------------------------------------- client
def client_main(sock_path: str, out: str) -> int:
    with RemoteVideoStore(sock_path) as cli:
        transport = cli.transport
        results = run_workload(cli)
        arrays, meta = {}, []
        for i, r in enumerate(results):
            regs = []
            for j, (f, box, px) in enumerate(r.regions):
                arrays[f"px_{i}_{j}"] = np.ascontiguousarray(px)
                regs.append([f, list(box)])
            meta.append({"regions": regs,
                         "cache_misses": r.stats.cache_misses,
                         "cache_hits": r.stats.cache_hits,
                         "transport": transport,
                         "marshal_s": r.stats.marshal_s,
                         "payload_bytes": r.stats.payload_bytes})
    np.savez(out + ".npz", **arrays)
    pathlib.Path(out + ".json").write_text(json.dumps(meta))
    return 0


def load_client(out: str):
    meta = json.loads(pathlib.Path(out + ".json").read_text())
    npz = np.load(out + ".npz")
    results = []
    for i, m in enumerate(meta):
        regions = [(f, tuple(box), npz[f"px_{i}_{j}"])
                   for j, (f, box) in enumerate(m["regions"])]
        results.append((regions, m))
    return results


def assert_same_regions(a, b, where: str) -> None:
    assert len(a) == len(b), f"{where}: {len(a)} vs {len(b)} regions"
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1], f"{where}: region keys diverge"
        if not np.array_equal(ra[-1], rb[-1]):
            raise AssertionError(f"{where}: pixels not bit-identical at "
                                 f"frame {ra[0]}")


# --------------------------------------------------------------- parent
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
    raise RuntimeError("server socket never came up")


def client(sock_path: str, out: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--client", sock_path, out], env=port_env())


def smoke(transport: str, device: str) -> None:
    """One full smoke pass against a ``--transport <transport>`` server
    whose store runs on ``device``."""
    expected = EXPECT[transport]
    tmp = tempfile.mkdtemp(prefix=f"tasm_smoke_{transport}_")
    sock_path = os.path.join(tmp, "tasm.sock")
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tasm_serve", "--socket",
         sock_path, "--transport", transport, "--device", device],
        env=port_env())
    try:
        wait_for_socket(sock_path, server)
        frames, dets = corpus()

        # seed the server's store over the wire, and build the in-process
        # reference store identically (encode is deterministic)
        with RemoteVideoStore(sock_path) as seed:
            seed.add_video("cam0", encoder=ENC, policy=NoTilingPolicy())
            seed.ingest("cam0", frames)
            seed.add_detections("cam0", {f: d for f, d in enumerate(dets)})
            assert seed.config()["decode"].device.startswith(device), (
                f"server decodes on {seed.config()['decode'].device}")
        local = VideoStore(decode=DecodeConfig(device=device))
        local.add_video("cam0", encoder=ENC, policy=NoTilingPolicy())
        local.ingest("cam0", frames)
        local.add_detections("cam0", {f: d for f, d in enumerate(dets)})
        reference = run_workload(local)
        local.close()

        # two concurrent client processes over one server
        outs = [os.path.join(tmp, f"client{i}") for i in (1, 2)]
        clients = [client(sock_path, out) for out in outs]
        rcs = [c.wait(timeout=300) for c in clients]
        assert rcs == [0, 0], f"client exit codes {rcs}"
        got = [load_client(out) for out in outs]
        for out in got:
            for _, m in out:
                assert m["transport"] == expected, (
                    f"client negotiated {m['transport']!r}, expected "
                    f"{expected!r} from a --transport {transport} server")
        for (regions, _), ref in zip(got[0], reference):
            assert_same_regions(ref.regions, regions, "client1 vs local")
        for (r1, _), (r2, _) in zip(got[0], got[1]):
            assert_same_regions(r1, r2, "client1 vs client2")
        marshal = sum(m["marshal_s"] for out in got for _, m in out)
        print(f"# [{transport}] two concurrent clients bit-identical to "
              f"in-process execute on {device} "
              f"({sum(len(r) for r, _ in got[0])} regions, "
              f"negotiated {expected}, marshal {marshal:.4f}s)", flush=True)

        # a fresh third process repeating the workload must decode nothing
        with RemoteVideoStore(sock_path) as probe:
            tiles_before = probe.stats()["tiles_decoded_total"]
        out3 = os.path.join(tmp, "client3")
        rc = client(sock_path, out3).wait(timeout=300)
        assert rc == 0, f"repeat client exit code {rc}"
        repeat = load_client(out3)
        misses = sum(m["cache_misses"] for _, m in repeat)
        with RemoteVideoStore(sock_path) as probe:
            tiles_after = probe.stats()["tiles_decoded_total"]
        assert misses == 0, f"repeat client had {misses} cache misses"
        assert tiles_after == tiles_before, (
            f"repeat client decoded {tiles_after - tiles_before} tiles")
        for (r1, _), (r3, _) in zip(got[0], repeat):
            assert_same_regions(r1, r3, "client1 vs warm repeat")
        print(f"# [{transport}] warm repeat from a fresh process decoded "
              f"0 tiles ({misses} misses)", flush=True)

        # no leaked leases: with every client gone, the pool drains to 0
        # (poll briefly — the connection-drop release can lag the client
        # process's exit by a scheduler tick)
        if transport == "shm":
            deadline = time.time() + 30
            with RemoteVideoStore(sock_path, transport="socket") as probe:
                while True:
                    shm_stats = probe.stats().get("shm")
                    assert shm_stats is not None, "server lost shm stats"
                    if shm_stats["segments"] == 0:
                        break
                    assert time.time() < deadline, (
                        f"segment pool leaked {shm_stats['segments']} "
                        f"segments ({shm_stats['bytes']} bytes) after "
                        f"clients exited")
                    time.sleep(0.1)
            print(f"# [{transport}] segment pool drained to 0 after "
                  f"clients exited", flush=True)

        # clean shutdown: SIGTERM -> exit 0, socket unlinked, no orphan
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=60)
        assert rc == 0, f"server exit code {rc}"
        assert not os.path.exists(sock_path), "socket file left behind"
        print(f"# [{transport}] clean shutdown: exit 0, socket removed",
              flush=True)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait(timeout=30)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--client":
        return client_main(argv[1], argv[2])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--transport", default="both",
                    choices=("shm", "socket", "both"),
                    help="which reply transport(s) to smoke (default both)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    try:
        DecodeConfig(device=args.device).resolve()
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"server_smoke_torch: {e}", file=sys.stderr)
        return 1
    transports = (["shm", "socket"] if args.transport == "both"
                  else [args.transport])
    for transport in transports:
        smoke(transport, args.device)
    print("server_smoke_torch,0.0,ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
