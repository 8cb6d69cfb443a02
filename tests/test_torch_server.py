"""The port's serving entry point (``repro_torch.core.server`` /
``client``, ``python -m repro_torch.tasm_serve``) on the CPU
(``DecodeConfig(device="cpu")``).

A port server and a reference server (numpy oracle backend) over the same
small video give remote scans within the decode oracle's tolerance
(``atol=1e-3, rtol=1e-5``) of each other, with equal ``ScanStats``
counters.  Inside the port, remote scans, ``execute_many``, serving
sessions, concurrent clients, both transports and both codecs are
bit-identical to in-process ``execute()``.  Every socket and subprocess
wait has its own timeout, so a hang fails one test, not the suite."""
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import DecodeConfig as JaxDecodeConfig
from repro.core import NoTilingPolicy as JaxNoTilingPolicy
from repro.core import RemoteVideoStore as JaxRemoteVideoStore
from repro.core import VideoStore as JaxVideoStore
from repro.core import VideoStoreServer as JaxVideoStoreServer
from repro.core.cost import CostModel as JaxCostModel
from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (TASM, DecodeConfig, NoTilingPolicy,
                              RemoteVideoStore, VideoStore, VideoStoreServer,
                              wire)
from repro_torch.core.cost import CostModel
from repro_torch.core.shm import shm_available

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-3, 1e-5
ENC = EncoderConfig(gop=16, qp=8)
CPU = DecodeConfig(device="cpu")
#: the per-RPC deadline of every client, and the cap of every other wait
WAIT_S = 60
QUERIES = [("car", (0, 32)), ("person", (0, 16)), ("car", (16, 32))]


def _model(cls):
    m = cls(beta=1.4e-8, gamma=1e-5)
    m.encode_per_pixel = 3.4e-8
    m.encode_per_tile = 1e-4
    return m


def fill(store, frames, dets, policy, model, name="cam0"):
    store.add_video(name, encoder=ENC, policy=policy, cost_model=model)
    store.ingest(name, frames)
    store.add_detections(name, {f: d for f, d in enumerate(dets)})


def assert_regions_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1]
        np.testing.assert_array_equal(ra[-1], rb[-1])


def assert_regions_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        assert g[-1].dtype == w[-1].dtype and g[-1].shape == w[-1].shape
        np.testing.assert_allclose(g[-1], w[-1], atol=ATOL, rtol=RTOL)


def _port_store(small_video, **kw):
    frames, dets = small_video
    store = VideoStore(**{"decode": CPU, **kw})
    fill(store, frames, dets, NoTilingPolicy(), _model(CostModel))
    return store


@pytest.fixture
def served(tmp_path, small_video):
    """A port store on the CPU behind a Unix-socket server, kept open for
    in-process comparisons, and one connected client."""
    store = _port_store(small_video)
    sock = str(tmp_path / "port.sock")
    server = VideoStoreServer(store, path=sock, owns_store=False).start()
    client = RemoteVideoStore(sock, timeout=WAIT_S)
    yield store, server, client, sock
    client.close()
    server.stop()
    store.close()


def _scan(s, label, frames):
    return s.scan("cam0").labels(label).frames(*frames)


# ------------------------------------------------ port against reference
@pytest.mark.parametrize("label,frames", QUERIES)
def test_port_server_matches_reference_server(tmp_path, small_video, label,
                                              frames):
    vid_frames, dets = small_video
    ref_store = JaxVideoStore(decode=JaxDecodeConfig(backend="numpy"))
    fill(ref_store, vid_frames, dets, JaxNoTilingPolicy(),
         _model(JaxCostModel))
    port_store = _port_store(small_video)
    ref_sock, port_sock = str(tmp_path / "ref.sock"), str(tmp_path / "p.sock")
    with JaxVideoStoreServer(ref_store, path=ref_sock).start(), \
            VideoStoreServer(port_store, path=port_sock).start(), \
            JaxRemoteVideoStore(ref_sock, timeout=WAIT_S) as ref_cli, \
            RemoteVideoStore(port_sock, timeout=WAIT_S) as port_cli:
        want = _scan(ref_cli, label, frames).execute()
        got = _scan(port_cli, label, frames).execute()
        assert got.regions, "the workload should produce regions"
        assert_regions_close(got.regions, want.regions)
        for f in ("tiles_decoded", "pixels_decoded", "cache_hits",
                  "cache_misses", "regions"):
            assert getattr(got.stats, f) == getattr(want.stats, f), f
        assert got.plan.describe() == want.plan.describe()


# ------------------------------------------------- bit-identity inside
@pytest.mark.parametrize("label,frames", QUERIES)
def test_remote_scan_bit_identical_to_execute(served, label, frames):
    store, _, client, _ = served
    ref = _scan(store, label, frames).execute()
    got = _scan(client, label, frames).execute()
    assert got.regions
    assert_regions_equal(ref.regions, got.regions)
    assert got.stats.regions == ref.stats.regions


def test_execute_many_bit_identical(served):
    store, _, client, _ = served
    ref = [_scan(store, lbl, fr).execute() for lbl, fr in QUERIES]
    got = client.execute_many([_scan(client, lbl, fr) for lbl, fr in QUERIES])
    assert len(got) == len(QUERIES)
    for r, g in zip(ref, got):
        assert_regions_equal(r.regions, g.regions)


def test_serving_session_bit_identical(served):
    store, _, client, _ = served
    ref = [_scan(store, lbl, fr).execute() for lbl, fr in QUERIES]
    with client.serve() as session:
        futs = [session.submit(_scan(client, lbl, fr)) for lbl, fr in QUERIES]
        got = [f.result(timeout=WAIT_S) for f in futs]
    for r, g in zip(ref, got):
        assert_regions_equal(r.regions, g.regions)


def test_four_concurrent_clients_bit_identical(served):
    store, _, _, sock = served
    ref = {q: _scan(store, *q).execute() for q in QUERIES}
    errors, results = [], []

    def run(k):
        try:
            with RemoteVideoStore(sock, timeout=WAIT_S) as cli:
                for i in range(6):
                    q = QUERIES[(k + i) % len(QUERIES)]
                    results.append((q, _scan(cli, *q).execute()))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * WAIT_S)
    assert not any(t.is_alive() for t in threads), "a client hung"
    assert not errors, errors
    assert len(results) == 24
    for q, res in results:
        assert_regions_equal(ref[q].regions, res.regions)


def test_shm_and_socket_transports_bit_identical(served):
    if not shm_available():
        pytest.skip("no POSIX shared memory on this host")
    store, _, _, sock = served
    ref = _scan(store, "car", (0, 32)).execute()
    with RemoteVideoStore(sock, transport="shm", timeout=WAIT_S) as a, \
            RemoteVideoStore(sock, transport="socket", timeout=WAIT_S) as b:
        assert (a.transport, b.transport) == ("shm", "npz")
        ra = _scan(a, "car", (0, 32)).execute()
        rb = _scan(b, "car", (0, 32)).execute()
        assert (ra.stats.transport, rb.stats.transport) == ("shm", "npz")
        assert_regions_equal(ref.regions, ra.regions)
        assert_regions_equal(ra.regions, rb.regions)


@pytest.mark.parametrize("codec", ["json", "msgpack"])
def test_codecs_bit_identical(tmp_path, small_video, codec):
    if codec == "msgpack" and wire._msgpack is None:
        pytest.skip("msgpack is not installed")
    store = _port_store(small_video)
    sock = str(tmp_path / f"{codec}.sock")
    try:
        with VideoStoreServer(store, path=sock, owns_store=False,
                              codec=codec, transport="socket").start(), \
                RemoteVideoStore(sock, timeout=WAIT_S) as cli:
            assert cli.ping()["codec"] == codec
            for q in QUERIES:
                assert_regions_equal(_scan(store, *q).execute().regions,
                                     _scan(cli, *q).execute().regions)
    finally:
        store.close()


def test_config_round_trips_device(served):
    store, _, client, _ = served
    cfg = client.config()
    assert isinstance(cfg["decode"], DecodeConfig)
    assert cfg["decode"].device == "cpu"
    assert cfg["decode"].backend == "batched"
    assert cfg["decode"] == DecodeConfig.from_doc(store.config()["decode"])


def test_tasm_facade_on_cpu(small_video):
    frames, dets = small_video
    with pytest.warns(DeprecationWarning):
        tasm = TASM("cam0", ENC, policy=NoTilingPolicy(),
                    cost_model=_model(CostModel), decode=CPU)
    tasm.ingest(frames)
    tasm.add_detections({f: d for f, d in enumerate(dets)})
    store = _port_store(small_video)
    try:
        assert tasm.engine.decode_config.device == "cpu"
        assert_regions_equal(tasm.scan("car", (0, 32)).regions,
                             _scan(store, "car", (0, 32)).execute().regions)
    finally:
        store.close()
        tasm.engine.close()


# ------------------------------------------------------- the entry point
def _serve_cmd(*args):
    return [sys.executable, "-m", "repro_torch.tasm_serve", *args]


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), *sys.path]))


def test_cli_serves_and_shuts_down(tmp_path, small_video):
    frames, dets = small_video
    sock = str(tmp_path / "cli.sock")
    root = tmp_path / "root"
    proc = subprocess.Popen(
        _serve_cmd("--device", "cpu", "--socket", sock, "--store-root",
                   str(root)), env=_env(), cwd=ROOT)
    store = _port_store(small_video)
    try:
        deadline = time.time() + WAIT_S
        while not os.path.exists(sock):
            assert proc.poll() is None, "server died early"
            assert time.time() < deadline, "socket never appeared"
            time.sleep(0.05)
        with RemoteVideoStore(sock, timeout=WAIT_S) as client:
            assert client.ping()["pong"] is True
            assert client.config()["decode"].device == "cpu"
            fill(client, frames, dets, NoTilingPolicy(), _model(CostModel))
            got = _scan(client, "car", (0, 32)).execute()
            assert got.regions
            assert_regions_equal(_scan(store, "car", (0, 32)).execute()
                                 .regions, got.regions)
            client.shutdown_server()
        assert proc.wait(timeout=WAIT_S) == 0
        assert not os.path.exists(sock), "socket file left behind"
        assert (root / "catalog.json").exists()
    finally:
        store.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    sock = str(tmp_path / "nocard.sock")
    out = subprocess.run(_serve_cmd("--socket", sock), env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=WAIT_S)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not os.path.exists(sock)


def test_cli_pool_fits_its_tmpfs(tmp_path):
    """``tasm_serve`` caps its shared-memory reply pool at half the free
    space of the tmpfs (the pool never checks it), at most the default."""
    from repro_torch.core.shm import DEFAULT_POOL_BYTES
    from repro_torch.tasm_serve import shm_pool_bytes

    got = shm_pool_bytes(str(tmp_path))
    st = os.statvfs(tmp_path)
    half = st.f_bavail * st.f_frsize // 2
    # the free space may move between the two reads: allow 16 MiB of it
    assert 0 < got <= DEFAULT_POOL_BYTES
    assert got == DEFAULT_POOL_BYTES or abs(got - half) <= 16 << 20
