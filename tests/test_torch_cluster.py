"""The port's distributed VideoStore (``repro_torch.core.cluster``) on the
CPU: PlacementMap, ClusterRouter, replicated failover.

Every case of the reference's cluster suite runs here against the port,
with every node's store decoding and encoding on the CPU
(``DecodeConfig(device="cpu")``).  Beside them: the port's placement
equals the reference's name for name; a port cluster and a reference
cluster over the same frames answer the same scans within the decode
oracle's tolerance (``atol=1e-3, rtol=1e-5``) with equal shapes, rects
and decode counters; and the copied modules equal the reference's once
``repro_torch`` reads ``repro``, docstrings aside.

The contract under test: consistent-hash placement is stable (adding a
node moves ~1/N of ring owners) and balanced (bounded-load primaries);
the placement map survives a JSON round-trip; a multi-node cluster behind
the router is bit-identical to a single in-process store for
execute / execute_many / serve() — including mid-batch retiles and
``limit`` across videos on different nodes; and with K=2 replication,
killing a node loses no reads while the epoch check keeps a stale replica
from ever serving a pre-retile generation.
"""
import json
import pathlib

import numpy as np
import pytest

import repro.core as jax_core
import repro_torch.core as torch_core
from repro.codec.encode import EncoderConfig as JaxEncoderConfig
from repro.core.cost import CostModel as JaxCostModel
from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (ClusterClient, ClusterRouter,
                              ClusterRouterServer, DecodeConfig,
                              NoTilingPolicy, PlacementMap, VideoStore,
                              VideoStoreServer, uniform_layout, wire)
from repro_torch.core.cost import CostModel

from _torch_ast import code_only

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-3, 1e-5
CPU = DecodeConfig(device="cpu")
ENC = EncoderConfig(gop=16, qp=8)
MODEL = CostModel(beta=1.4e-8, gamma=1e-5)
MODEL.encode_per_pixel = 3.4e-8
MODEL.encode_per_tile = 1e-4


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


# ============================================================== placement
class TestPlacementMap:
    def test_ring_owner_deterministic(self):
        a = PlacementMap(["n0", "n1", "n2"])
        b = PlacementMap(["n2", "n0", "n1"])  # order-independent ring
        for i in range(50):
            assert a.ring_owner(f"cam{i}") == b.ring_owner(f"cam{i}")

    def test_adding_a_node_moves_about_one_over_n(self):
        """The consistent-hashing contract: growing N-1 -> N nodes
        re-homes ~1/N of ring owners, nowhere near the ~(N-1)/N a mod-N
        hash would."""
        videos = [f"cam{i}" for i in range(400)]
        pm3 = PlacementMap(["n0", "n1", "n2"], vnodes=128)
        before = {v: pm3.ring_owner(v) for v in videos}
        pm3.add_node("n3")
        moved = sum(1 for v in videos if pm3.ring_owner(v) != before[v])
        # expectation 1/4 = 100 of 400; generous band, but well under the
        # ~300 a naive rehash would move
        assert 40 <= moved <= 180
        # every move lands on the NEW node (CH only steals, never shuffles)
        for v in videos:
            if pm3.ring_owner(v) != before[v]:
                assert pm3.ring_owner(v) == "n3"

    def test_bounded_load_primaries_balanced(self):
        pm = PlacementMap(["n0", "n1", "n2"], replication=2)
        for i in range(12):
            pm.place(f"cam{i}")
        counts = {n: 0 for n in pm.nodes}
        for reps in pm.assignments.values():
            counts[reps[0]] += 1
        assert max(counts.values()) - min(counts.values()) <= 1
        # replicas are distinct nodes
        for reps in pm.assignments.values():
            assert len(reps) == 2 and len(set(reps)) == 2

    def test_place_is_sticky(self):
        pm = PlacementMap(["n0", "n1"])
        first = pm.place("cam0")
        pm.add_node("n2")  # membership change must not re-home cam0
        assert pm.place("cam0") == first
        assert pm.nodes_for("cam0") == first

    def test_round_trip_through_json_file(self, tmp_path):
        path = str(tmp_path / "placement.json")
        pm = PlacementMap(["n0", "n1", "n2"], replication=2, vnodes=32,
                          path=path)
        for i in range(7):
            pm.place(f"cam{i}")
        pm2 = PlacementMap.load(path)
        assert pm2.nodes == pm.nodes
        assert pm2.replication == 2 and pm2.vnodes == 32
        assert pm2.assignments == pm.assignments
        # the persisted doc is plain JSON (operators can read/edit it)
        doc = json.loads(open(path).read())
        assert doc["version"] == 1 and len(doc["assignments"]) == 7

    def test_plan_rebalance_suggests_never_applies(self):
        pm = PlacementMap(["n0", "n1"], vnodes=128)
        for i in range(40):
            pm.place(f"cam{i}")
        snap = {v: list(r) for v, r in pm.assignments.items()}
        pm.add_node("n2")
        moves = pm.plan_rebalance()
        assert moves, "adding a node should suggest some moves"
        for v, (cur, new) in moves.items():
            assert cur == snap[v][0] and new != cur
        # the new node is the dominant target (CH steals toward it; a few
        # moves also undo old bounded-load redirects)
        assert sum(1 for _, new in moves.values() if new == "n2") \
            >= len(moves) * 0.5
        # nothing moved by itself
        assert {v: list(r) for v, r in pm.assignments.items()} == snap


# ================================================================ cluster
@pytest.fixture
def cluster(tmp_path, small_video):
    """3 nodes + router (K=2) and a single reference store seeded with
    the same two videos, so every test can assert bit-identity."""
    frames, dets = small_video
    nodes, servers = {}, []
    for i in range(3):
        p = str(tmp_path / f"n{i}.sock")
        servers.append(VideoStoreServer(VideoStore(decode=CPU),
                                        path=p).start())
        nodes[f"n{i}"] = p
    router = ClusterRouter(nodes, replication=2,
                           placement_path=str(tmp_path / "placement.json"))
    ref = VideoStore(decode=CPU)
    for name in ("cam0", "cam1"):
        fill(router, name, frames, dets)
        fill(ref, name, frames, dets)
    yield router, ref, servers, nodes
    router.close()
    for s in servers:
        s.stop()
    ref.close()


class TestClusterBitIdentity:
    def test_execute_matches_single_store(self, cluster):
        router, ref, _, _ = cluster
        for q in (lambda s: s.scan("cam0").labels("car").frames(0, 32),
                  lambda s: s.scan("cam1").labels("person").frames(8, 24),
                  lambda s: s.scan(["cam0", "cam1"]).labels("car")
                  .frames(0, 32)):
            assert_regions_equal(q(ref).execute().regions,
                                 q(router).execute().regions)

    def test_limit_spends_sequentially_across_nodes(self, cluster):
        router, ref, _, _ = cluster
        q = lambda s: s.scan(["cam0", "cam1"]).labels("car") \
            .frames(0, 32).limit(5)
        r, g = q(ref).execute(), q(router).execute()
        assert_regions_equal(r.regions, g.regions)
        assert g.stats.regions == r.stats.regions == 5

    def test_execute_many_strict_submission_order(self, cluster):
        router, ref, _, _ = cluster
        mk = lambda s: [s.scan("cam0").labels("car").frames(0, 32),
                        s.scan("cam1").labels("car").frames(0, 16),
                        s.scan("cam0").labels("person").frames(0, 32),
                        s.scan(["cam0", "cam1"]).labels("car").frames(16, 32)]
        refs = [q.execute() for q in mk(ref)]
        gots = router.execute_many(mk(router))
        assert len(gots) == 4
        for r, g in zip(refs, gots):
            assert_regions_equal(r.regions, g.regions)

    def test_serve_session_with_mid_batch_retile(self, cluster):
        router, ref, _, _ = cluster
        q = lambda s: s.scan("cam0").labels("car").frames(0, 32)
        with router.serve() as session:
            first = session.submit(q(router)).result()
            dt = router.retile("cam0", 0, uniform_layout(96, 160, 2, 2))
            assert dt > 0
            second = session.submit(q(router)).result()
        expect = q(ref).execute()
        assert_regions_equal(expect.regions, first.regions)
        # retiling changes the physical layout, never the bits
        assert_regions_equal(expect.regions, second.regions)
        assert router._epochs["cam0"][0] >= 1

    def test_explain_routes(self, cluster):
        router, ref, _, _ = cluster
        r = ref.scan("cam0").labels("car").frames(0, 32).explain()
        g = router.scan("cam0").labels("car").frames(0, 32).explain()
        assert g.est_pixels == r.est_pixels
        assert [s.tile_idxs for s in g.sot_scans] == \
            [s.tile_idxs for s in r.sot_scans]

    def test_mutations_hit_every_replica(self, cluster):
        router, _, _, nodes = cluster
        reps = router.placement.nodes_for("cam0")
        assert len(reps) == 2
        router.add_metadata("cam0", 0, "thing", 8, 8, 40, 40)
        from repro_torch.core import RemoteVideoStore
        for node in reps:
            with RemoteVideoStore(nodes[node]) as direct:
                r = direct.scan("cam0").labels("thing").frames(0, 8) \
                    .execute()
                assert len(r.regions) == 1


class TestClusterClient:
    def test_front_end_serves_identical_results(self, cluster, tmp_path):
        router, ref, _, _ = cluster
        sock = str(tmp_path / "router.sock")
        with ClusterRouterServer(router, path=sock,
                                 owns_store=False).start():
            with ClusterClient(sock) as cc:
                pong = cc.ping()
                assert pong["cluster"] is True
                assert pong["nodes"] == ["n0", "n1", "n2"]
                assert sorted(cc.videos()) == ["cam0", "cam1"]
                q = lambda s: s.scan(["cam0", "cam1"]).labels("car") \
                    .frames(0, 32)
                assert_regions_equal(q(ref).execute().regions,
                                     q(cc).execute().regions)
                got = cc.execute_many([
                    cc.scan("cam0").labels("car").frames(0, 16),
                    cc.scan("cam1").labels("person").frames(0, 32)])
                refs = [ref.scan("cam0").labels("car").frames(0, 16)
                        .execute(),
                        ref.scan("cam1").labels("person").frames(0, 32)
                        .execute()]
                for r, g in zip(refs, got):
                    assert_regions_equal(r.regions, g.regions)
                assert cc.placement()["assignments"] == \
                    {v: list(r) for v, r in
                     router.placement.assignments.items()}
                assert cc.node_health() == {"n0": True, "n1": True,
                                            "n2": True}


class TestFailover:
    def _kill(self, cluster, video):
        router, _, servers, _ = cluster
        primary = router.placement.primary(video)
        servers[int(primary[1:])].stop()
        return primary

    def test_reads_survive_primary_death(self, cluster):
        router, ref, _, _ = cluster
        expect = ref.scan("cam0").labels("car").frames(0, 32).execute()
        primary = self._kill(cluster, "cam0")
        got = router.scan("cam0").labels("car").frames(0, 32).execute()
        assert_regions_equal(expect.regions, got.regions)
        assert primary in router._down
        # repeat read sticks to the surviving replica (it is now warm)
        got2 = router.scan("cam0").labels("car").frames(0, 32).execute()
        assert_regions_equal(expect.regions, got2.regions)

    def test_batches_survive_node_death_mid_routing(self, cluster):
        router, ref, _, _ = cluster
        self._kill(cluster, "cam0")
        mk = lambda s: [s.scan("cam0").labels("car").frames(0, 32),
                        s.scan("cam1").labels("car").frames(0, 32)]
        refs = [q.execute() for q in mk(ref)]
        gots = router.execute_many(mk(router))
        for r, g in zip(refs, gots):
            assert_regions_equal(r.regions, g.regions)

    def test_stale_replica_never_serves_pre_retile_layout(self, cluster):
        """The epoch-consistency check: a replica that missed a retile
        (it was down when the mutation fanned out) is excluded from reads
        for that video even after it comes back."""
        router, ref, servers, _ = cluster
        reps = router.placement.nodes_for("cam0")
        replica = reps[1]
        servers[int(replica[1:])].stop()
        # retile while the replica is down: it misses the epoch bump
        dt = router.retile("cam0", 0, uniform_layout(96, 160, 2, 2))
        assert dt > 0
        assert (("cam0", replica) in router._stale)
        # node comes back (same store object would be wrong here — the
        # point is the ROUTER must not read cam0 from it regardless)
        assert router._reader_name("cam0") == reps[0]
        got = router.scan("cam0").labels("car").frames(0, 32).execute()
        expect = ref.scan("cam0").labels("car").frames(0, 32).execute()
        assert_regions_equal(expect.regions, got.regions)

    def test_all_replicas_down_raises(self, cluster):
        router, _, servers, _ = cluster
        for name in router.placement.nodes_for("cam0"):
            servers[int(name[1:])].stop()
        with pytest.raises((wire.ConnectionClosed, OSError)):
            router.scan("cam0").labels("car").frames(0, 32).execute()

    def test_replica_epochs_agree_after_router_retile(self, cluster):
        router, _, _, nodes = cluster
        from repro_torch.core import RemoteVideoStore
        router.retile("cam0", 1, uniform_layout(96, 160, 2, 2))
        tables = []
        for node in router.placement.nodes_for("cam0"):
            with RemoteVideoStore(nodes[node]) as direct:
                tables.append(direct.epochs("cam0"))
        assert tables[0] == tables[1]
        assert tables[0][1] == 1  # the retiled SOT bumped everywhere

    def test_channel_closed_by_another_thread_fails_over(self, cluster):
        """One thread marks the primary down and closes its channel while
        another thread already holds that channel: the second thread's
        read fails over to the replica instead of failing.  A closed
        client raises ``ClientClosed``, a ``RuntimeError`` as before and a
        ``ConnectionClosed`` the router's failover catches."""
        router, ref, _, _ = cluster
        expect = ref.scan("cam0").labels("car").frames(0, 32).execute()
        primary = router.placement.primary("cam0")
        held = router._channel(primary)
        router._mark_down(primary)          # the other thread's failure
        with router._lock:                  # ...and the node answers again
            router._down.discard(primary)
        with pytest.raises(RuntimeError, match="closed") as err:
            held.ping()
        assert isinstance(err.value, wire.ConnectionClosed)
        real = router._channel
        router._channel = lambda name: held if name == primary \
            else real(name)
        try:
            got = router.scan("cam0").labels("car").frames(0, 32).execute()
        finally:
            router._channel = real
        assert_regions_equal(expect.regions, got.regions)
        assert primary in router._down


class TestRouterAccounting:
    def test_stats_merge_and_down_marking(self, cluster):
        router, _, servers, _ = cluster
        router.scan("cam0").labels("car").frames(0, 32).execute()
        doc = router.stats()
        assert doc["videos"] == ["cam0", "cam1"]
        assert doc["replication"] == 2
        assert set(doc["nodes"]) == {"n0", "n1", "n2"}
        assert doc["tiles_decoded_total"] > 0
        live = [d for d in doc["nodes"].values() if d]
        assert doc["storage_bytes"] == sum(d["storage_bytes"]
                                           for d in live)
        servers[0].stop()
        assert router.ping_nodes() == {"n0": False, "n1": True,
                                       "n2": True}
        assert router.stats()["nodes"]["n0"] is None

    def test_tuner_stats_summed(self, cluster):
        router, _, _, _ = cluster
        ts = router.drain_tuner(timeout=30)
        from repro_torch.core.tuner import TunerStats
        assert isinstance(ts, TunerStats)
        total = router.tuner_stats()
        assert total.observed >= 0

    def test_ingest_rejects_on_any_replica_semantic_error(self, cluster,
                                                          small_video):
        router, _, _, _ = cluster
        frames, _ = small_video
        with pytest.raises(ValueError, match="already"):
            router.ingest("cam0", frames)

    def test_unknown_video_raises_key_error(self, cluster):
        router, _, _, _ = cluster
        with pytest.raises(KeyError, match="unknown video"):
            router.scan("nope").labels("car").execute()


# ======================================================= port vs reference
def test_placement_equals_reference():
    """The sha1 ring and the bounded-load walk are framework-free: the
    port places 400 names exactly where the reference does."""
    names = [f"cam{i}" for i in range(400)]
    ours = PlacementMap(["n0", "n1", "n2"], replication=2, vnodes=64)
    theirs = jax_core.PlacementMap(["n0", "n1", "n2"], replication=2,
                                   vnodes=64)
    for v in names:
        assert ours.ring_owner(v) == theirs.ring_owner(v), v
        assert ours.place(v) == theirs.place(v), v
    assert ours.to_doc() == theirs.to_doc()
    assert ours.plan_rebalance() == theirs.plan_rebalance()


def assert_regions_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        assert g[-1].dtype == w[-1].dtype and g[-1].shape == w[-1].shape
        np.testing.assert_allclose(g[-1], w[-1], atol=ATOL, rtol=RTOL)


def _jax_model():
    m = JaxCostModel(beta=1.4e-8, gamma=1e-5)
    m.encode_per_pixel = 3.4e-8
    m.encode_per_tile = 1e-4
    return m


def _twin(core, tmp_path, small_video, side):
    """A 3-node K=2 cluster of ``core``'s in-process servers, seeded with
    cam0 and cam1 (the reference decodes with its numpy oracle backend,
    the port on the CPU)."""
    frames, dets = small_video
    if core is jax_core:
        mk = lambda: core.VideoStore(  # noqa: E731
            decode=core.DecodeConfig(backend="numpy"))
        enc, model = JaxEncoderConfig(gop=16, qp=8), _jax_model
    else:
        mk = lambda: VideoStore(decode=CPU)  # noqa: E731
        enc, model = ENC, lambda: MODEL
    nodes, servers = {}, []
    for i in range(3):
        p = str(tmp_path / f"{side}{i}.sock")
        servers.append(core.VideoStoreServer(mk(), path=p).start())
        nodes[f"n{i}"] = p
    router = core.ClusterRouter(nodes, replication=2)
    for name in ("cam0", "cam1"):
        router.add_video(name, encoder=enc, policy=core.NoTilingPolicy(),
                         cost_model=model())
        router.ingest(name, frames)
        router.add_detections(name, {f: d for f, d in enumerate(dets)})
    return router, servers


TWIN_QUERIES = [("cam0", "car", (0, 32)), ("cam1", "person", (8, 24)),
                (["cam0", "cam1"], "car", (0, 32)),
                ("cam1", "car", (16, 32))]


def test_cluster_matches_reference_cluster(tmp_path, small_video):
    """The same scans through a reference cluster and a port cluster:
    regions within the decode oracle's tolerance, equal rects and shapes,
    equal per-scan and summed decode counters."""
    ref, ref_servers = _twin(jax_core, tmp_path, small_video, "ref")
    port, port_servers = _twin(torch_core, tmp_path, small_video, "port")
    try:
        assert port.placement.to_doc() == ref.placement.to_doc()

        def scans(router):
            return [router.scan(v).labels(lbl).frames(*fr)
                    for v, lbl, fr in TWIN_QUERIES]

        def served(router):
            with router.serve() as session:
                futs = [session.submit(q) for q in scans(router)]
                return [f.result(timeout=60) for f in futs]

        runs = {}
        for side, router in (("ref", ref), ("port", port)):
            runs[side] = ([q.execute() for q in scans(router)]
                          + router.execute_many(scans(router))
                          + served(router))
        assert len(runs["port"]) == 3 * len(TWIN_QUERIES)
        for got, want in zip(runs["port"], runs["ref"]):
            assert got.regions, "the workload should produce regions"
            assert_regions_close(got.regions, want.regions)
            for f in ("tiles_decoded", "pixels_decoded", "regions"):
                assert getattr(got.stats, f) == getattr(want.stats, f), f
        got, want = port.stats(), ref.stats()
        for f in ("tiles_decoded_total", "pixels_decoded_total"):
            assert got[f] == want[f] > 0, f
    finally:
        for router, servers in ((ref, ref_servers), (port, port_servers)):
            router.close()
            for s in servers:
                s.stop()


@pytest.mark.parametrize("module", ["cluster", "repair"])
def test_copy_equals_reference_module(module):
    port = ROOT / "src" / "repro_torch" / "core" / f"{module}.py"
    ref = ROOT / "src" / "repro" / "core" / f"{module}.py"
    assert code_only(port, rename=True) == code_only(ref)
