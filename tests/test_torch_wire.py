"""The port's wire and shared-memory layers (``repro_torch.core.wire``,
``repro_torch.core.shm``): the cases of ``tests/test_wire.py`` and
``tests/test_shm.py`` that hold for the copies, run against the port's
modules and a port store on the CPU, with every codec this host has.

Beyond the reference's cases: frames cross between the two packages in
both directions (the framing is the same), and each package reads only its
own environment names (``REPRO_TORCH_WIRE``, ``REPRO_TORCH_TRANSPORT``)."""
import gc
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.core import wire as ref_wire
from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (DecodeConfig, NoTilingPolicy, RemoteVideoStore,
                              VideoStore, VideoStoreServer, wire)
from repro_torch.core.cost import CostModel
from repro_torch.core.query import (PhysicalPlan, ScanPlan, ScanQuery,
                                    ScanResult, ScanStats, SOTScan)
from repro_torch.core.shm import (SegmentPool, attach_segment,
                                  resolve_transport, shm_available)
from repro_torch.tasm_serve import parse_args

CODECS = ["json"] + (["msgpack"] if wire._msgpack is not None else [])
ENC = EncoderConfig(gop=16, qp=8)
MODEL = CostModel(beta=1.4e-8, gamma=1e-5)
CPU = DecodeConfig(device="cpu")
#: every socket read in these tests gives up after this many seconds
WAIT_S = 60


def _pair():
    a, b = socket.socketpair()
    b.settimeout(WAIT_S)
    return a, b


def fill(store, name, frames, dets):
    store.add_video(name, encoder=ENC, policy=NoTilingPolicy(),
                    cost_model=MODEL)
    store.ingest(name, frames)
    store.add_detections(name, {f: d for f, d in enumerate(dets)})


def assert_regions_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1]
        np.testing.assert_array_equal(ra[-1], rb[-1])


def wait_until(cond, timeout=20.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def shm():
    if not shm_available():
        pytest.skip("no POSIX shared memory on this host")


@pytest.fixture
def served_shm(shm, tmp_path, small_video):
    """A port store on the CPU behind a Unix-socket server with the shm
    transport offered (auto); the store stays open for comparisons."""
    frames, dets = small_video
    store = VideoStore(decode=CPU)
    fill(store, "cam0", frames, dets)
    sock = str(tmp_path / "tasm.sock")
    server = VideoStoreServer(store, path=sock, owns_store=False).start()
    yield store, server, sock
    server.stop()
    store.close()


def pool_stats(server):
    return server._shm_pool.stats()


# ----------------------------------------------------------------- framing
@pytest.mark.parametrize("codec", CODECS)
class TestFraming:
    def test_doc_roundtrip(self, codec):
        doc = {"id": 3, "op": "x", "nested": {"a": [1, 2.5, None, "s"]},
               "flag": True}
        assert wire.loads(wire.dumps(doc, codec=codec)) == doc

    def test_ndarray_npz_roundtrip(self, codec):
        arrs = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
                "u8": np.arange(8, dtype=np.uint8),
                "i64": np.array([[-(2 ** 40), 7]]),
                "empty": np.zeros((0, 3), dtype=np.float32)}
        doc = {"id": 0, "data": arrs, "list": [arrs["f32"], 1]}
        out = wire.loads(wire.dumps(doc, codec=codec))
        for k, a in arrs.items():
            got = out["data"][k]
            assert got.dtype == a.dtype and got.shape == a.shape
            np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(out["list"][0], arrs["f32"])

    def test_socket_roundtrip(self, codec):
        a, b = _pair()
        try:
            doc = {"id": 1, "arr": np.ones((2, 2), dtype=np.float32)}
            wire.write_frame(a, doc, codec=codec)
            out = wire.read_frame(b)
            assert out["id"] == 1
            np.testing.assert_array_equal(out["arr"], doc["arr"])
        finally:
            a.close()
            b.close()

    def test_oversized_dumps_rejected(self, codec):
        doc = {"id": 0, "blob": np.zeros(100_000, dtype=np.float32)}
        with pytest.raises(wire.WireError, match="exceeds"):
            wire.dumps(doc, codec=codec, max_bytes=1024)

    def test_numpy_scalars_coerced(self, codec):
        doc = {"id": 0, "i": np.int64(7), "f": np.float32(1.5),
               "b": np.bool_(True)}
        out = wire.loads(wire.dumps(doc, codec=codec))
        assert out == {"id": 0, "i": 7, "f": 1.5, "b": True}

    @pytest.mark.parametrize("direction", ["port_to_reference",
                                           "reference_to_port"])
    def test_frames_cross_packages(self, codec, direction):
        doc = {"id": 4, "op": "scan", "px": np.arange(20, dtype=np.float32)
               .reshape(4, 5), "nested": [{"a": np.ones(3, np.uint8)}]}
        send, recv = ((wire, ref_wire) if direction == "port_to_reference"
                      else (ref_wire, wire))
        out = recv.loads(send.dumps(doc, codec=codec))
        assert out["id"] == 4 and out["op"] == "scan"
        np.testing.assert_array_equal(out["px"], doc["px"])
        np.testing.assert_array_equal(out["nested"][0]["a"],
                                      doc["nested"][0]["a"])


class TestFragmentedReads:
    """``read_frame`` against short/fragmented ``recv`` returns."""

    @staticmethod
    def _dribble(sock, data: bytes, chunks) -> threading.Thread:
        def _send():
            pos = 0
            for c in chunks:
                sock.sendall(data[pos:pos + c])
                pos += c
                time.sleep(0.001)
            assert pos == len(data)
        t = threading.Thread(target=_send, daemon=True)
        t.start()
        return t

    def _frame_bytes(self, doc) -> bytes:
        payload = wire.dumps(doc)
        return struct.pack(">I", len(payload)) + payload

    def test_one_byte_at_a_time(self):
        a, b = _pair()
        try:
            doc = {"id": 9, "op": "ping", "arr": np.arange(6,
                                                           dtype=np.uint8)}
            data = self._frame_bytes(doc)
            t = self._dribble(a, data, [1] * len(data))
            out = wire.read_frame(b)
            t.join(timeout=WAIT_S)
            assert out["id"] == 9 and out["op"] == "ping"
            np.testing.assert_array_equal(out["arr"], doc["arr"])
        finally:
            a.close()
            b.close()

    @pytest.mark.parametrize("split", [1, 2, 3])
    def test_header_split_across_recvs(self, split):
        a, b = _pair()
        try:
            data = self._frame_bytes({"id": 1, "v": "x"})
            t = self._dribble(a, data, [split, len(data) - split])
            assert wire.read_frame(b)["id"] == 1
            t.join(timeout=WAIT_S)
        finally:
            a.close()
            b.close()

    def test_split_straddles_header_payload_boundary(self):
        a, b = _pair()
        try:
            data = self._frame_bytes({"id": 2, "v": [1, 2, 3]})
            t = self._dribble(a, data, [3, 4, len(data) - 7])
            assert wire.read_frame(b)["v"] == [1, 2, 3]
            t.join(timeout=WAIT_S)
        finally:
            a.close()
            b.close()

    def test_two_frames_dribbled_back_to_back(self):
        a, b = _pair()
        try:
            data = self._frame_bytes({"id": 1}) + self._frame_bytes(
                {"id": 2, "arr": np.ones((2, 3), dtype=np.float32)})
            chunks = [5] * (len(data) // 5) + [len(data) % 5]
            t = self._dribble(a, data, [c for c in chunks if c])
            first = wire.read_frame(b)
            second = wire.read_frame(b)
            t.join(timeout=WAIT_S)
            assert first["id"] == 1 and second["id"] == 2
            np.testing.assert_array_equal(
                second["arr"], np.ones((2, 3), dtype=np.float32))
        finally:
            a.close()
            b.close()

    def test_eof_after_partial_payload_is_truncation(self):
        a, b = _pair()
        data = self._frame_bytes({"id": 3})
        a.sendall(data[:len(data) - 2])
        a.close()
        with pytest.raises(wire.WireError, match="mid-frame"):
            wire.read_frame(b)
        b.close()


class TestFramingRejects:
    def test_oversized_header_rejected_before_alloc(self):
        a, b = _pair()
        try:
            a.sendall(struct.pack(">I", 1 << 30))
            with pytest.raises(wire.WireError, match="limit"):
                wire.read_frame(b, max_bytes=1 << 20)
        finally:
            a.close()
            b.close()

    def test_clean_eof_vs_truncation(self):
        a, b = _pair()
        a.close()
        with pytest.raises(wire.ConnectionClosed):
            wire.read_frame(b)
        b.close()
        a, b = _pair()
        a.sendall(struct.pack(">I", 100) + b"short")
        a.close()
        with pytest.raises(wire.WireError, match="mid-frame"):
            wire.read_frame(b)
        b.close()

    @pytest.mark.parametrize("payload", [
        b"garbage-with-no-tag", b"Mnot-msgpack" if wire._msgpack else b"J{",
        b"J{truncated", b"Z???", b"J[1,2,3]"])
    def test_malformed_payloads_raise_wire_error(self, payload):
        with pytest.raises(wire.WireError):
            wire.loads(payload)

    def test_zero_length_frame_rejected(self):
        a, b = _pair()
        try:
            a.sendall(struct.pack(">I", 0))
            with pytest.raises(wire.WireError, match="zero-length"):
                wire.read_frame(b)
        finally:
            a.close()
            b.close()

    def test_object_arrays_rejected_sender_side(self):
        doc = {"id": 0, "a": np.array([{"x": 1}], dtype=object)}
        with pytest.raises(wire.WireError, match="object-dtype"):
            wire.dumps(doc)


class TestEnvironmentNames:
    def test_port_reads_its_own_wire_name(self, monkeypatch):
        monkeypatch.setenv("REPRO_WIRE", "bogus")  # the reference's name
        monkeypatch.setenv("REPRO_TORCH_WIRE", "json")
        assert wire.default_codec() == "json"
        monkeypatch.setenv("REPRO_TORCH_WIRE", "bogus")
        with pytest.raises(ValueError, match="REPRO_TORCH_WIRE"):
            wire.default_codec()

    def test_port_reads_its_own_transport_name(self, monkeypatch):
        monkeypatch.setenv("REPRO_TRANSPORT", "bogus")
        monkeypatch.delenv("REPRO_TORCH_TRANSPORT", raising=False)
        assert resolve_transport(None) == "auto"
        monkeypatch.setenv("REPRO_TORCH_TRANSPORT", "socket")
        assert resolve_transport(None) == "socket"
        assert resolve_transport("auto") == "auto"
        monkeypatch.setenv("REPRO_TORCH_TRANSPORT", "bogus")
        with pytest.raises(ValueError, match="REPRO_TORCH_TRANSPORT"):
            resolve_transport(None)
        assert resolve_transport("shm") == "shm"


# ------------------------------------------------------------ query docs
class TestQueryDocs:
    def test_scan_query_roundtrip_including_partial(self):
        q = ScanQuery(None, ("a", "b")).labels("car", "person") \
            .frames(4, 32).limit(5).decode(False)
        q2 = ScanQuery.from_doc(None, wire.loads(wire.dumps(q.to_doc())))
        assert q2.plan() == q.plan()
        partial = ScanQuery(None, "v")
        p2 = ScanQuery.from_doc(None, partial.to_doc())
        assert p2._cnf is None and p2.to_doc() == partial.to_doc()

    def test_scan_stats_roundtrip(self):
        s = ScanStats(lookup_s=0.1, decode_s=0.5, pixels_decoded=123.0,
                      tiles_decoded=3.0, cache_hits=2, cache_misses=1,
                      regions=7)
        s2 = ScanStats.from_doc(wire.loads(wire.dumps(s.to_doc())))
        assert s2 == s and s2.cache_hit_rate == s.cache_hit_rate

    def test_physical_plan_roundtrip(self):
        ss = SOTScan(video="v", sot_id=2, epoch=1, tile_idxs=(0, 3),
                     n_frames=16,
                     boxes_by_frame={4: [(0, 0, 8, 8), (8, 8, 24, 24)]},
                     query_range=(0, 32), labels=("car",),
                     est_pixels=100.0, est_tiles=2.0, est_cost_s=0.01,
                     blocks_by_tile={0: (0, 1, 5), 3: None})
        pp = PhysicalPlan(logical=ScanPlan(videos=("v",), cnf=(("car",),)),
                          sot_scans=[ss], lookup_s=0.002)
        pp2 = PhysicalPlan.from_doc(wire.loads(wire.dumps(pp.to_doc())))
        assert pp2.logical == pp.logical and pp2.sot_scans[0] == ss
        assert pp2.describe() == pp.describe()

    def test_result_roundtrip(self):
        px = np.arange(64, dtype=np.float32).reshape(8, 8)
        regions = [(3, (0, 0, 8, 8), px), (4, (8, 0, 16, 8), px * 2)]
        r = ScanResult(regions=regions, stats=ScanStats(regions=2),
                       plan=None, regions_by_video={"v": regions})
        r2 = ScanResult.from_doc(wire.loads(wire.dumps(r.to_doc())))
        assert_regions_equal(r.regions, r2.regions)
        assert isinstance(r2.regions[0][1], tuple)


# ----------------------------------------------------- SegmentPool units
class TestSegmentPool:
    def test_write_release_accounting(self, shm):
        pool = SegmentPool(max_bytes=1 << 20)
        a = np.arange(100, dtype=np.int64)
        b = np.zeros((3, 4), dtype=np.uint8)
        doc = pool.write([a, b], owner="conn")
        assert doc is not None and len(doc["items"]) == 2
        st = pool.stats()
        assert st["segments"] == 1 and st["bytes"] >= a.nbytes + b.nbytes
        seg = attach_segment(doc["seg"])
        try:
            for src, (off, shape, dtype) in zip((a, b), doc["items"]):
                got = np.frombuffer(seg.buf, dtype=np.dtype(dtype),
                                    count=int(np.prod(shape)) or 0,
                                    offset=off).reshape(shape).copy()
                np.testing.assert_array_equal(got, src)
        finally:
            seg.close()
        assert pool.release([doc["seg"]]) == 1
        assert pool.stats() == {"segments": 0, "bytes": 0}
        assert pool.release([doc["seg"]]) == 0
        pool.close()

    def test_owner_filtering(self, shm):
        pool = SegmentPool()
        owner_a, owner_b = object(), object()
        doc = pool.write([np.ones(8)], owner=owner_a)
        assert pool.release([doc["seg"]], owner=owner_b) == 0
        assert pool.stats()["segments"] == 1
        assert pool.release([doc["seg"]], owner=owner_a) == 1
        pool.close()

    def test_release_owner_and_sweep(self, shm):
        pool = SegmentPool()
        live, dead = object(), object()
        pool.write([np.ones(4)], owner=live)
        pool.write([np.ones(4)], owner=dead)
        pool.write([np.ones(4)], owner=dead)
        assert pool.release_owner(dead) == 2
        assert pool.stats()["segments"] == 1
        assert pool.sweep(live_owners=[]) == 1
        assert pool.stats() == {"segments": 0, "bytes": 0}
        pool.close()

    def test_budget_overflow_falls_back(self, shm):
        pool = SegmentPool(max_bytes=128)
        assert pool.write([np.zeros(1024, dtype=np.uint8)]) is None
        assert pool.write([np.zeros(16, dtype=np.uint8)]) is not None
        pool.close()

    def test_closed_pool_declines(self, shm):
        pool = SegmentPool()
        doc = pool.write([np.ones(4)])
        pool.close()
        assert pool.stats() == {"segments": 0, "bytes": 0}
        assert pool.write([np.ones(4)]) is None
        assert doc is not None

    def test_probe_verify(self, shm):
        pool = SegmentPool()
        name, nbytes = pool.probe(owner="c")
        seg = attach_segment(name)
        try:
            nonce = bytes(seg.buf[:nbytes])
        finally:
            seg.close()
        assert pool.verify(name, "deadbeef") is False
        assert pool.verify(name, "not-hex") is False
        assert pool.verify(name, nonce.hex()) is True
        pool.close()


# -------------------------------------------------- transport negotiation
class TestNegotiation:
    def test_unix_auto_negotiates_shm(self, served_shm):
        _, server, sock = served_shm
        assert server.transport == "auto"
        with RemoteVideoStore(sock, timeout=WAIT_S) as cli:
            assert cli.transport == "shm"
            assert cli.ping()["transport"] == "shm"

    def test_socket_server_declines(self, served_shm, tmp_path):
        store, _, _ = served_shm
        sock2 = str(tmp_path / "npz.sock")
        with VideoStoreServer(store, path=sock2, owns_store=False,
                              transport="socket").start():
            with RemoteVideoStore(sock2, timeout=WAIT_S) as cli:
                assert cli.transport == "npz"
                assert cli.ping()["transport"] == "npz"
            with pytest.raises(RuntimeError, match="shm"):
                RemoteVideoStore(sock2, transport="shm", timeout=WAIT_S)

    def test_client_socket_mode_skips_negotiation(self, served_shm):
        _, _, sock = served_shm
        with RemoteVideoStore(sock, transport="socket",
                              timeout=WAIT_S) as cli:
            assert cli.transport == "npz"

    def test_tcp_auto_silently_npz(self, served_shm):
        store, _, _ = served_shm
        with VideoStoreServer(store, host="127.0.0.1", port=0,
                              owns_store=False).start() as tcp:
            host, port = tcp.address
            with RemoteVideoStore(host=host, port=port,
                                  timeout=WAIT_S) as cli:
                assert cli.transport == "npz"
                ref = store.scan("cam0").labels("car").frames(0, 16) \
                    .execute()
                got = cli.scan("cam0").labels("car").frames(0, 16) \
                    .execute()
                assert_regions_equal(ref.regions, got.regions)

    def test_invalid_transport_values_raise(self, served_shm, tmp_path):
        _, _, sock = served_shm
        with pytest.raises(ValueError, match="auto|shm|socket"):
            RemoteVideoStore(sock, transport="carrier-pigeon",
                             timeout=WAIT_S)
        with pytest.raises(ValueError, match="auto|shm|socket"):
            VideoStoreServer(VideoStore(decode=CPU),
                             path=str(tmp_path / "x.sock"),
                             transport="bogus")

    def test_serve_cli_rejects_bogus_transport(self):
        with pytest.raises(SystemExit):
            parse_args(["--socket", "/tmp/x.sock",
                        "--transport", "carrier-pigeon"])

    def test_wire_frame_with_shm_needs_reader(self):
        payload = wire.dumps(
            {"v": np.arange(6).reshape(2, 3)},
            segment_writer=lambda arrays: {"seg": "fake", "items":
                                           [[0, [2, 3], "int64"]]})
        with pytest.raises(wire.WireError, match="shm reader"):
            wire.loads(payload)


# ---------------------------------------------------- interop + identity
class TestInterop:
    def test_shm_and_npz_clients_bit_identical(self, served_shm):
        store, _, sock = served_shm
        ref = store.scan("cam0").labels("car").frames(0, 32).execute()
        with RemoteVideoStore(sock, timeout=WAIT_S) as shm_cli, \
                RemoteVideoStore(sock, transport="socket",
                                 timeout=WAIT_S) as npz_cli:
            assert (shm_cli.transport, npz_cli.transport) == ("shm", "npz")
            a = shm_cli.scan("cam0").labels("car").frames(0, 32).execute()
            b = npz_cli.scan("cam0").labels("car").frames(0, 32).execute()
            assert_regions_equal(ref.regions, a.regions)
            assert_regions_equal(ref.regions, b.regions)
            by_t = shm_cli.stats()["marshalling"]["by_transport"]
            assert by_t.get("shm", 0) >= 1 and by_t.get("npz", 0) >= 1

    def test_shm_views_are_read_only(self, served_shm):
        _, _, sock = served_shm
        with RemoteVideoStore(sock, timeout=WAIT_S) as cli:
            got = cli.scan("cam0").labels("car").frames(0, 32).execute()
            assert got.regions
            px = got.regions[0][-1]
            assert px.flags.writeable is False
            with pytest.raises(ValueError):
                px[...] = 0

    def test_stats_stamped_on_served_replies(self, served_shm):
        store, _, sock = served_shm
        ref = store.scan("cam0").labels("car").frames(0, 32).execute()
        assert ref.stats.transport == ""
        with RemoteVideoStore(sock, timeout=WAIT_S) as cli:
            got = cli.scan("cam0").labels("car").frames(0, 32).execute()
            assert got.stats.transport == "shm"
            assert got.stats.payload_bytes > 0
            assert got.stats.marshal_s >= 0.0
            assert cli.stats()["marshalling"]["payload_bytes"] >= \
                got.stats.payload_bytes


# ------------------------------------------------------- lease lifecycle
class TestLeases:
    def test_gc_of_result_releases_segments(self, served_shm):
        _, server, sock = served_shm
        with RemoteVideoStore(sock, timeout=WAIT_S) as cli:
            got = cli.scan("cam0").labels("car").frames(0, 32).execute()
            assert got.regions
            assert pool_stats(server)["segments"] >= 1
            del got
            gc.collect()
            wait_until(lambda: pool_stats(server)["segments"] == 0,
                       what="pool to drain after result GC")
            again = cli.scan("cam0").labels("car").frames(0, 32).execute()
            assert again.regions

    def test_client_close_flushes_leases(self, served_shm):
        _, server, sock = served_shm
        cli = RemoteVideoStore(sock, timeout=WAIT_S)
        got = cli.scan("cam0").labels("car").frames(0, 32).execute()
        assert got.regions and pool_stats(server)["segments"] >= 1
        cli.close()
        wait_until(lambda: pool_stats(server)["segments"] == 0,
                   what="pool to drain on client close")
        assert int(np.asarray(got.regions[0][-1]).sum()) >= 0

    def test_sigkilled_client_leases_are_reclaimed(self, served_shm,
                                                   tmp_path):
        _, server, sock = served_shm
        marker = str(tmp_path / "holding")
        prog = (
            "import sys, time\n"
            "from repro_torch.core import RemoteVideoStore\n"
            "sock, marker = sys.argv[1], sys.argv[2]\n"
            "cli = RemoteVideoStore(sock, timeout=60)\n"
            "r = cli.scan('cam0').labels('car').frames(0, 32).execute()\n"
            "assert cli.transport == 'shm', cli.transport\n"
            "assert r.regions\n"
            "open(marker, 'w').write(str(len(r.regions)))\n"
            "time.sleep(300)  # hold the lease until SIGKILL\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
        proc = subprocess.Popen([sys.executable, "-c", prog, sock, marker],
                                env=env)
        try:
            wait_until(lambda: os.path.exists(marker) or
                       proc.poll() is not None, timeout=120,
                       what="client to take its lease")
            assert proc.poll() is None, "client died before holding lease"
            assert pool_stats(server)["segments"] >= 1
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            wait_until(lambda: pool_stats(server)["segments"] == 0,
                       what="server to reclaim orphaned leases")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)

    def test_execute_many_over_shm(self, served_shm):
        store, server, sock = served_shm
        mk = lambda s: [s.scan("cam0").labels("car").frames(0, 32),
                        s.scan("cam0").labels("person").frames(0, 16)]
        ref = [q.execute() for q in mk(store)]
        with RemoteVideoStore(sock, timeout=WAIT_S) as cli:
            got = cli.execute_many(mk(cli))
            for r, g in zip(ref, got):
                assert_regions_equal(r.regions, g.regions)
            del got, g
            gc.collect()
            wait_until(lambda: pool_stats(server)["segments"] == 0,
                       what="pool to drain after execute_many GC")
