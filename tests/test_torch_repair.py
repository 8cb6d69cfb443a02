"""The port's self-healing cluster data plane (``repro_torch.core.repair``
and ``cluster``) on the CPU: node→node tile streaming, background
re-replication/rebalance, fault injection, per-RPC deadlines.

Every case of the reference's repair suite runs here against the port,
with every node's store decoding and encoding on the CPU
(``DecodeConfig(device="cpu")``), through the reference's fault proxy
(``tests/faults.py``) unchanged.

The contract under test: killing a replica permanently and running
``router.repair(node=...)`` restores the replication factor with reads
bit-identical to a single store throughout; the chunked copy path
survives byte-level faults (mid-stream disconnects, torn frames, slow and
hung links) by resuming — never by serving torn state; a foreground
retile racing the copy forces a re-stream, and the rebuilt replica never
serves the pre-retile generation; a destination that dies mid-copy leaves
zero torn state (staged chunks are either intact-and-reused or
discarded); and ``PlacementMap.save`` survives SIGKILL mid-save
(old-or-new, never torn).
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (ClusterRouter, DecodeConfig, NoTilingPolicy,
                              PlacementMap, RemoteVideoStore, VideoStore,
                              VideoStoreServer, uniform_layout, wire)
from repro_torch.core.cost import CostModel
from repro_torch.core.storage import tile_checksum

from faults import Fault, FaultProxy

CPU = DecodeConfig(device="cpu")
ENC = EncoderConfig(gop=16, qp=8)
MODEL = CostModel(beta=1.4e-8, gamma=1e-5)
MODEL.encode_per_pixel = 3.4e-8
MODEL.encode_per_tile = 1e-4

NODES = ["n0", "n1", "n2"]


def assert_regions_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1]
        np.testing.assert_array_equal(ra[-1], rb[-1])


def fill(store, name, frames, dets):
    store.add_video(name, encoder=ENC, policy=NoTilingPolicy(),
                    cost_model=MODEL)
    store.ingest(name, frames)
    store.add_detections(name, {f: d for f, d in enumerate(dets)})


class Cluster:
    """3 nodes, K=2, one video ``cam0`` — with an optional FaultProxy
    wired in front of the repair source or destination.  Placement is
    computed up front so tests can choose *which* role gets the proxy
    before the router ever dials."""

    def __init__(self, tmp_path, small_video, *, proxy_role=None,
                 faults=(), timeout=None, dst_root=False,
                 health_interval=None):
        frames, dets = small_video
        pm = PlacementMap(NODES, replication=2,
                          path=str(tmp_path / "placement.json"))
        reps = pm.place("cam0")
        self.src, self.victim = reps[0], reps[1]
        self.dst = next(n for n in NODES if n not in reps)
        self.stores, self.servers, self.nodes = {}, {}, {}
        for n in NODES:
            root = str(tmp_path / f"store-{n}") \
                if (dst_root and n == self.dst) else None
            st = VideoStore(root, decode=CPU)
            p = str(tmp_path / f"{n}.sock")
            self.stores[n] = st
            self.servers[n] = VideoStoreServer(st, path=p,
                                               owns_store=False).start()
            self.nodes[n] = p
        self.proxy = None
        if proxy_role is not None:
            behind = {"src": self.src, "dst": self.dst}[proxy_role]
            self.proxy = FaultProxy(self.nodes[behind])
            self.nodes = dict(self.nodes, **{behind: self.proxy.address})
        self.router = ClusterRouter(self.nodes, placement=pm,
                                    timeout=timeout,
                                    health_interval=health_interval)
        self.ref = VideoStore(decode=CPU)
        fill(self.router, "cam0", frames, dets)
        fill(self.ref, "cam0", frames, dets)
        for f in faults:  # queued only now: fill traffic stays clean
            self.proxy.add_fault(f)

    def kill(self, name):
        self.servers.pop(name).stop()
        self.stores.pop(name).close()

    def q(self, store):
        return store.scan("cam0").labels("car").frames(0, 32).execute()

    def close(self):
        self.router.close()
        if self.proxy is not None:
            self.proxy.close()
        for s in self.servers.values():
            s.stop()
        for s in self.stores.values():
            s.close()
        self.ref.close()


# ============================================================= checksums
class TestTileChecksum:
    def _enc(self):
        rng = np.random.default_rng(0)
        return {"h": 96, "w": 160, "gop": 16, "qp": 8, "n_frames": 32,
                "size_bytes": 123.5,
                "kq": [rng.integers(0, 255, (6, 4), dtype=np.uint8)
                       for _ in range(2)],
                "pq": [rng.integers(0, 255, (6, 4), dtype=np.uint8)
                       for _ in range(2)]}

    def test_stable(self):
        a, b = self._enc(), self._enc()
        assert tile_checksum(a) == tile_checksum(b)

    def test_member_corruption_detected(self):
        a, b = self._enc(), self._enc()
        b["kq"][1] = b["kq"][1].copy()
        b["kq"][1][3, 2] ^= 0xFF
        assert tile_checksum(a) != tile_checksum(b)

    def test_meta_corruption_detected(self):
        a, b = self._enc(), self._enc()
        b["gop"] = 8
        assert tile_checksum(a) != tile_checksum(b)


# ===================================================== repair, no faults
class TestRepairBasics:
    def test_node_loss_repair_restores_replication(self, tmp_path,
                                                   small_video):
        c = Cluster(tmp_path, small_video)
        try:
            expect = c.q(c.ref)
            c.kill(c.victim)
            # reads fail over while under-replicated
            assert_regions_equal(expect.regions, c.q(c.router).regions)
            jobs = c.router.repair(node=c.victim)
            assert [j["video"] for j in jobs] == ["cam0"]
            status = c.router.drain_repair(timeout=60)
            assert [j["status"] for j in status["jobs"]] == ["done"]
            reps = c.router.placement.nodes_for("cam0")
            assert c.victim not in reps and c.dst in reps
            assert len(reps) == 2
            assert_regions_equal(expect.regions, c.q(c.router).regions)
            # the fresh replica really holds the bits: read it directly
            with RemoteVideoStore(c.nodes[c.dst]) as direct:
                assert_regions_equal(expect.regions,
                                     c.q(direct).regions)
        finally:
            c.close()

    def test_repair_is_idempotent_when_healthy(self, tmp_path,
                                               small_video):
        c = Cluster(tmp_path, small_video)
        try:
            assert c.router.repair() == []
        finally:
            c.close()

    def test_repair_without_any_live_source_fails_cleanly(self, tmp_path,
                                                          small_video):
        c = Cluster(tmp_path, small_video)
        try:
            c.kill(c.src)
            c.kill(c.victim)
            c.router.ping_nodes()  # notice the deaths
            c.router.repair(video="cam0")
            with pytest.raises(RuntimeError, match="no live replica"):
                c.router.drain_repair(timeout=60)
            status = c.router.repair_status()
            assert [j["status"] for j in status["jobs"]] == ["failed"]
        finally:
            c.close()


# ======================================================== fault injection
class TestCopyPathFaults:
    @pytest.mark.parametrize("cut", [150, 2500, 12000])
    def test_disconnect_mid_copy_resumes(self, tmp_path, small_video,
                                         cut):
        """The destination link is severed ``cut`` bytes in — twice —
        then relays cleanly: the copy resumes from staged chunks and the
        repaired replica is bit-identical."""
        c = Cluster(tmp_path, small_video, proxy_role="dst",
                    faults=[Fault(cut_after=cut), Fault(cut_after=cut)])
        try:
            expect = c.q(c.ref)
            c.kill(c.victim)
            c.router.repair(node=c.victim)
            status = c.router.drain_repair(timeout=120)
            (job,) = status["jobs"]
            assert job["status"] == "done"
            assert c.proxy.faults_fired == 2
            assert job["retries"] >= 1
            assert_regions_equal(expect.regions, c.q(c.router).regions)
            with RemoteVideoStore(c.nodes[c.dst]) as direct:
                assert_regions_equal(expect.regions, c.q(direct).regions)
        finally:
            c.close()

    def test_torn_export_reply_retried(self, tmp_path, small_video):
        """A byte flipped in the source's reply stream makes the frame
        undecodable — the chunk is re-exported on a fresh connection."""
        c = Cluster(tmp_path, small_video, proxy_role="src",
                    faults=[Fault(corrupt_at=600, direction="b2c")])
        try:
            expect = c.q(c.ref)
            c.kill(c.victim)
            c.router.repair(node=c.victim)
            status = c.router.drain_repair(timeout=120)
            (job,) = status["jobs"]
            assert job["status"] == "done"
            assert c.proxy.faults_fired == 1
            assert_regions_equal(expect.regions, c.q(c.router).regions)
        finally:
            c.close()

    def test_torn_upload_hits_deadline_then_resumes(self, tmp_path,
                                                    small_video):
        """A byte flipped in an upload leaves the request unanswerable
        (the node can't correlate an undecodable frame) — the per-RPC
        deadline severs the hang and the chunk is re-sent."""
        c = Cluster(tmp_path, small_video, proxy_role="dst", timeout=10.0,
                    faults=[Fault(corrupt_at=1500, direction="c2b")])
        try:
            expect = c.q(c.ref)
            c.kill(c.victim)
            t0 = time.monotonic()
            c.router.repair(node=c.victim)
            status = c.router.drain_repair(timeout=120)
            (job,) = status["jobs"]
            assert job["status"] == "done"
            assert c.proxy.faults_fired == 1
            assert time.monotonic() - t0 < 60
            assert_regions_equal(expect.regions, c.q(c.router).regions)
        finally:
            c.close()

    def test_slow_link_still_completes(self, tmp_path, small_video):
        c = Cluster(tmp_path, small_video, proxy_role="dst",
                    faults=[Fault(delay_s=0.05)])
        try:
            expect = c.q(c.ref)
            c.kill(c.victim)
            c.router.repair(node=c.victim)
            status = c.router.drain_repair(timeout=120)
            assert [j["status"] for j in status["jobs"]] == ["done"]
            assert_regions_equal(expect.regions, c.q(c.router).regions)
        finally:
            c.close()

    def test_exhausted_retries_fail_the_job_not_the_worker(
            self, tmp_path, small_video):
        """More consecutive faults than ``chunk_retries``: the job fails
        with a clean error, the destination holds no torn video, and a
        retried repair (faults exhausted) completes."""
        c = Cluster(tmp_path, small_video, proxy_role="dst",
                    faults=[Fault(cut_after=100) for _ in range(8)])
        try:
            expect = c.q(c.ref)
            c.kill(c.victim)
            c.router.repair(node=c.victim)
            with pytest.raises((wire.WireError, OSError)):
                c.router.drain_repair(timeout=120)
            # no torn state: dst never learned the video
            assert "cam0" not in c.stores[c.dst].videos()
            assert c.proxy.pending_faults() <= 3
            c.proxy.clear_faults()
            c.router.repair(node=c.victim)
            status = c.router.drain_repair(timeout=120)
            assert status["jobs"][-1]["status"] == "done"
            assert_regions_equal(expect.regions, c.q(c.router).regions)
        finally:
            c.close()


# ================================================== repair vs retile race
class TestRepairRetileRace:
    def test_mid_copy_retile_forces_restream(self, tmp_path, small_video):
        """A foreground retile lands while the copy streams: the worker
        re-streams the bumped SOT and the rebuilt replica serves the
        post-retile generation — never the stale one."""
        c = Cluster(tmp_path, small_video)
        retile_wanted = threading.Event()
        retile_done = threading.Event()
        src_store = c.stores[c.src]
        real = src_store.export_tile
        calls = [0]

        def hooked(name, sot_id, tile_idx):
            calls[0] += 1
            if calls[0] == 2:
                retile_wanted.set()
                assert retile_done.wait(timeout=30)
            return real(name, sot_id, tile_idx)

        src_store.export_tile = hooked
        try:
            c.kill(c.victim)
            c.router.repair(node=c.victim)
            assert retile_wanted.wait(timeout=30)
            c.router.retile("cam0", 0, uniform_layout(96, 160, 2, 2))
            c.ref.retile("cam0", 0, uniform_layout(96, 160, 2, 2))
            retile_done.set()
            status = c.router.drain_repair(timeout=120)
            (job,) = status["jobs"]
            assert job["status"] == "done"
            assert job["restreams"] >= 1
            expected = c.router.expected_epochs("cam0")
            assert expected[0] >= 1
            with RemoteVideoStore(c.nodes[c.dst]) as direct:
                have = direct.epochs("cam0")
                assert all(have[s] >= e for s, e in expected.items())
                assert_regions_equal(c.q(c.ref).regions,
                                     c.q(direct).regions)
            assert_regions_equal(c.q(c.ref).regions, c.q(c.router).regions)
        finally:
            src_store.export_tile = real
            c.close()


# ============================================= destination dies mid-copy
class TestDestinationRestart:
    def test_disk_staging_survives_destination_restart(self, tmp_path,
                                                       small_video):
        """The destination dies after staging the first chunk; a
        brand-new store process over the same root resumes from the
        intact staged chunk, commits, and cleans staging up."""
        c = Cluster(tmp_path, small_video, dst_root=True)
        dst_store = c.stores[c.dst]
        real = dst_store.stage_import_chunk
        calls = [0]

        def dying(*a, **kw):
            calls[0] += 1
            if calls[0] > 1:
                raise RuntimeError("injected destination crash")
            return real(*a, **kw)

        dst_store.stage_import_chunk = dying
        try:
            expect = c.q(c.ref)
            c.kill(c.victim)
            c.router.repair(node=c.victim)
            with pytest.raises(RuntimeError,
                               match="injected destination crash"):
                c.router.drain_repair(timeout=120)
            staging = tmp_path / f"store-{c.dst}" / ".import" / "cam0"
            staged_before = sorted(p.name for p in staging.glob("*.npz"))
            assert len(staged_before) == 1  # chunk 1 landed intact
            # no torn state: dst never learned the video
            assert "cam0" not in dst_store.videos()
            # "restart": a brand-new store process over the same root
            c.servers.pop(c.dst).stop()
            dst_store.close()
            st = VideoStore(str(tmp_path / f"store-{c.dst}"), decode=CPU)
            c.stores[c.dst] = st
            c.servers[c.dst] = VideoStoreServer(
                st, path=str(tmp_path / f"{c.dst}.sock"),
                owns_store=False).start()
            before = c.router.repair_status()["stats"]["chunks_copied"]
            c.router.repair(node=c.victim)
            status = c.router.drain_repair(timeout=120)
            job2 = status["jobs"][-1]
            assert job2["status"] == "done"
            assert job2["chunks_done"] == job2["chunks_total"] >= 2
            # the staged chunk was reused: one fewer chunk went over the
            # wire than the manifest expects
            streamed = status["stats"]["chunks_copied"] - before
            assert streamed == job2["chunks_total"] - 1
            assert not staging.exists()  # staging discarded after commit
            assert_regions_equal(expect.regions, c.q(c.router).regions)
            with RemoteVideoStore(c.nodes[c.dst]) as direct:
                assert_regions_equal(expect.regions, c.q(direct).regions)
        finally:
            c.close()


# ===================================================== per-RPC deadlines
class TestClientDeadline:
    def test_hung_node_raises_within_deadline(self, tmp_path):
        srv = VideoStoreServer(VideoStore(decode=CPU),
                               path=str(tmp_path / "n.sock")).start()
        proxy = FaultProxy(str(tmp_path / "n.sock"),
                           faults=[Fault(stall_s=60, direction="b2c")])
        try:
            # transport="socket": skip shm negotiation so ping is the
            # first RPC on the wire and hits the deadline itself
            with RemoteVideoStore(proxy.address, retries=0, timeout=0.5,
                                  transport="socket") as c:
                t0 = time.monotonic()
                with pytest.raises(wire.ConnectionClosed, match="deadline"):
                    c.ping()
                assert time.monotonic() - t0 < 5
        finally:
            proxy.close()
            srv.stop()

    def test_no_deadline_by_default(self, tmp_path):
        srv = VideoStoreServer(VideoStore(decode=CPU),
                               path=str(tmp_path / "n.sock")).start()
        try:
            with RemoteVideoStore(str(tmp_path / "n.sock"),
                                  retries=0) as c:
                assert c._timeout is None
                c.ping()
        finally:
            srv.stop()


# ==================================================== router health loop
class TestHealthLoop:
    def test_downed_node_revived_in_background(self, tmp_path):
        p = str(tmp_path / "n0.sock")
        srv = VideoStoreServer(VideoStore(decode=CPU), path=p).start()
        router = ClusterRouter({"n0": p}, health_interval=0.05)
        try:
            assert router._health_thread is not None
            srv.stop()
            router._mark_down("n0")
            assert "n0" in router._down
            srv = VideoStoreServer(VideoStore(decode=CPU), path=p).start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with router._lock:
                    if "n0" not in router._down:
                        break
                time.sleep(0.02)
            assert "n0" not in router._down
        finally:
            router.close()
            srv.stop()

    def test_no_thread_without_interval(self, tmp_path):
        p = str(tmp_path / "n0.sock")
        srv = VideoStoreServer(VideoStore(decode=CPU), path=p).start()
        router = ClusterRouter({"n0": p})
        try:
            assert router._health_thread is None
        finally:
            router.close()
            srv.stop()


# ============================================== join + rebalance movement
class TestJoinAndRebalance:
    def test_join_fresh_node_and_rebalance_moves_data(self, tmp_path,
                                                      small_video):
        frames, dets = small_video
        nodes, servers = {}, []
        for i in range(2):
            p = str(tmp_path / f"n{i}.sock")
            servers.append(VideoStoreServer(VideoStore(decode=CPU),
                                            path=p).start())
            nodes[f"n{i}"] = p
        router = ClusterRouter(nodes, replication=1)
        ref = VideoStore(decode=CPU)
        for v in ("cam0", "cam1", "cam2", "cam3"):
            fill(router, v, frames, dets)
            fill(ref, v, frames, dets)
        try:
            p2 = str(tmp_path / "n2.sock")
            servers.append(VideoStoreServer(VideoStore(decode=CPU),
                                            path=p2).start())
            out = router.join_node("n2", p2)
            assert out["alive"] and "n2" in router.placement.nodes
            doc = router.rebalance(apply=True)
            moved = [j["video"] for j in doc["jobs"]] + doc["flipped"]
            assert moved, "a fresh node should attract some videos"
            status = router.drain_repair(timeout=120)
            assert all(j["status"] == "done" for j in status["jobs"])
            for v in moved:  # each video now fronted by its planned owner
                assert router.placement.primary(v) == doc["moves"][v][1]
            assert any(doc["moves"][v][1] == "n2" for v in moved)
            for v in ("cam0", "cam1", "cam2", "cam3"):
                a = ref.scan(v).labels("car").frames(0, 32).execute()
                b = router.scan(v).labels("car").frames(0, 32).execute()
                assert_regions_equal(a.regions, b.regions)
        finally:
            router.close()
            for s in servers:
                s.stop()
            ref.close()

    def test_join_conflicting_address_rejected(self, tmp_path):
        p = str(tmp_path / "n0.sock")
        srv = VideoStoreServer(VideoStore(decode=CPU), path=p).start()
        router = ClusterRouter({"n0": p})
        try:
            with pytest.raises(ValueError, match="already registered"):
                router.join_node("n0", "/elsewhere.sock")
        finally:
            router.close()
            srv.stop()


# ================================================= placement durability
class TestPlacementDurability:
    SAVER = textwrap.dedent("""\
        import sys
        sys.path.insert(0, {src!r})
        from repro_torch.core import PlacementMap
        pm = PlacementMap(["n0", "n1", "n2"], replication=2, path={path!r})
        state = lambda i: {{f"cam{{j}}": ["n0", "n1"] if i % 2 == 0
                           else ["n1", "n2"] for j in range(64)}}
        pm.assignments = state(0)
        pm.save()   # a valid generation exists before the kill window
        print("ready", flush=True)
        i = 0
        while True:
            i += 1
            pm.assignments = state(i)
            pm.save()
    """)

    def test_sigkill_mid_save_leaves_old_or_new(self, tmp_path):
        src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
        path = str(tmp_path / "placement.json")
        code = self.SAVER.format(src=os.path.abspath(src), path=path)
        for attempt in range(5):
            proc = subprocess.Popen([sys.executable, "-c", code],
                                    stdout=subprocess.PIPE)
            assert proc.stdout.readline().strip() == b"ready"
            time.sleep(0.05 + 0.037 * attempt)  # vary the kill point
            proc.kill()
            proc.wait(timeout=30)
            # never torn: the file parses and is one of the two states
            pm = PlacementMap.load(path)
            reps = {tuple(r) for r in pm.assignments.values()}
            assert reps <= {("n0", "n1"), ("n1", "n2")}
            assert len(reps) == 1, "half-written generation visible"
            assert len(pm.assignments) == 64
