"""``python -m repro_torch.tasm_router`` on the CPU: a router process in
front of ``python -m repro_torch.tasm_serve --device cpu`` node processes.

Routed scans are bit-identical to an in-process port store; the admin
modes (``--repair-status``, ``--join-node``, ``--repair``) exit 0 and the
repaired replica holds the bits; SIGTERM shuts the router and the nodes
down with exit 0 and removes their sockets.  Every subprocess and socket
wait has its own timeout, so a hang fails one test, not the suite."""
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (ClusterClient, DecodeConfig, NoTilingPolicy,
                              RemoteVideoStore, VideoStore)
from repro_torch.core.cost import CostModel
from repro_torch.tasm_router import parse_args

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENC = EncoderConfig(gop=16, qp=8)
CPU = DecodeConfig(device="cpu")
#: the per-RPC deadline of every client, and the cap of every other wait
WAIT_S = 60


def _model():
    m = CostModel(beta=1.4e-8, gamma=1e-5)
    m.encode_per_pixel = 3.4e-8
    m.encode_per_tile = 1e-4
    return m


def fill(store, frames, dets, name="cam0"):
    store.add_video(name, encoder=ENC, policy=NoTilingPolicy(),
                    cost_model=_model())
    store.ingest(name, frames)
    store.add_detections(name, {f: d for f, d in enumerate(dets)})


def assert_regions_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1]
        np.testing.assert_array_equal(ra[-1], rb[-1])


def _scan(s):
    return s.scan("cam0").labels("car").frames(0, 32).execute()


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *sys.path]))


class Procs:
    """Node and router subprocesses, each logging to a file and waited
    for until its socket file exists."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.procs: dict = {}

    def start(self, name, module, *args):
        sock = str(self.tmp / f"{name}.sock")
        log = open(self.tmp / f"{name}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", module, "--socket", sock, *args],
            env=_env(), cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        self.procs[name] = (proc, sock)
        return proc, sock

    def wait_ready(self, *names):
        deadline = time.time() + WAIT_S
        for name in names:
            proc, sock = self.procs[name]
            while not os.path.exists(sock):
                assert proc.poll() is None, \
                    f"{name} died early: {self.log(name)}"
                assert time.time() < deadline, f"{name}: no socket"
                time.sleep(0.05)

    def node(self, name):
        self.start(name, "repro_torch.tasm_serve", "--device", "cpu",
                   "--tuning", "off")
        return self.procs[name][1]

    def log(self, name):
        return (self.tmp / f"{name}.log").read_text()

    def close(self):
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def _admin(router_sock, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tasm_router", "--socket",
         router_sock, *args], env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=2 * WAIT_S)


@pytest.fixture
def cli_cluster(tmp_path, small_video):
    """Two ``tasm_serve --device cpu`` nodes behind a K=2 router process,
    cam0 ingested through the router, and an in-process store of the same
    frames."""
    frames, dets = small_video
    procs = Procs(tmp_path)
    nodes = {n: procs.node(n) for n in ("a", "b")}
    procs.wait_ready("a", "b")
    _, router = procs.start(
        "router", "repro_torch.tasm_router", "--replication", "2",
        "--timeout", str(WAIT_S), "--placement",
        str(tmp_path / "placement.json"),
        *[a for n, p in nodes.items() for a in ("--node", f"{n}={p}")])
    procs.wait_ready("router")
    store = VideoStore(decode=CPU)
    fill(store, frames, dets)
    try:
        with ClusterClient(router, timeout=WAIT_S) as cc:
            fill(cc, frames, dets)
        yield procs, nodes, router, store
    finally:
        store.close()
        procs.close()


def test_router_cli_serves_routed_scans(cli_cluster):
    procs, nodes, router, store = cli_cluster
    want = _scan(store)
    assert want.regions
    with ClusterClient(router, timeout=WAIT_S) as cc:
        pong = cc.ping()
        assert pong["cluster"] is True and pong["nodes"] == ["a", "b"]
        assert cc.placement()["assignments"]["cam0"] in (["a", "b"],
                                                         ["b", "a"])
        assert_regions_equal(want.regions, _scan(cc).regions)
        (got,) = cc.execute_many([cc.scan("cam0").labels("car")
                                  .frames(0, 32)])
        assert_regions_equal(want.regions, got.regions)
        cfg = cc.config()["nodes"]
        assert sorted(cfg) == ["a", "b"]
        assert all(c["decode"].device == "cpu" for c in cfg.values())
    # both replicas hold the video
    for sock in nodes.values():
        with RemoteVideoStore(sock, timeout=WAIT_S) as direct:
            assert_regions_equal(want.regions, _scan(direct).regions)
    assert "TASM router serving on" in procs.log("router")


def test_router_cli_join_and_repair(cli_cluster):
    procs, nodes, router, store = cli_cluster
    out = _admin(router, "--repair-status")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["jobs"] == []
    out = _admin(router, "--repair")  # healthy: nothing to copy
    assert out.returncode == 0, out.stderr
    assert "0 copy job(s) enqueued" in out.stdout
    victim, _ = procs.procs["b"]
    victim.kill()
    victim.wait(timeout=WAIT_S)
    c = procs.node("c")
    procs.wait_ready("c")
    out = _admin(router, "--join-node", f"c={c}")
    assert out.returncode == 0, out.stderr
    assert "joined c (alive)" in out.stdout
    out = _admin(router, "--repair", "node=b", "--wait", str(WAIT_S))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "done" in out.stdout
    out = _admin(router, "--repair-status")
    assert out.returncode == 0, out.stderr
    (job,) = json.loads(out.stdout)["jobs"]
    assert job["status"] == "done" and job["dst"] == "c"
    assert job["chunks_done"] == job["chunks_total"] > 0
    want = _scan(store)
    with RemoteVideoStore(c, timeout=WAIT_S) as direct:
        assert_regions_equal(want.regions, _scan(direct).regions)
    with ClusterClient(router, timeout=WAIT_S) as cc:
        assert sorted(cc.placement()["assignments"]["cam0"]) == ["a", "c"]
        assert_regions_equal(want.regions, _scan(cc).regions)


def test_router_cli_sigterm_exits_zero(cli_cluster):
    procs, nodes, router, _ = cli_cluster
    for name in ("router", "a", "b"):
        proc, sock = procs.procs[name]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0, procs.log(name)
        assert not os.path.exists(sock), f"{name}: socket left behind"


def test_router_cli_argument_rules():
    args = parse_args(["--socket", "r.sock", "--node", "a=/a.sock",
                       "--node", "b=h:7841", "--replication", "2"])
    assert not args.admin and args.replication == 2
    assert parse_args(["--socket", "r.sock", "--repair", "node=b"]).admin
    assert not hasattr(parse_args(["--socket", "r.sock", "--node",
                                   "a=/a.sock"]), "device")
    with pytest.raises(SystemExit):  # serve mode needs a node
        parse_args(["--socket", "r.sock"])
    with pytest.raises(SystemExit):  # admin modes take no --node
        parse_args(["--socket", "r.sock", "--repair-status", "--node",
                    "a=/a.sock"])
