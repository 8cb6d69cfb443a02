"""The port's background physical tuner (``tests/test_tuner.py`` on
``repro_torch``): observation emission off the scan path, drain barrier,
coalescing, racing-scan bit-identity, policy runtime-state persistence
(manifest v3), and crash-safe log ordering.  Every store decodes and
encodes on the CPU (``DecodeConfig(device="cpu")``) through the batched
path the card runs: the tuner thread's retiles encode through
``encode_tiles`` while scan threads decode."""
import json
import threading

import numpy as np
import pytest

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (DecodeConfig, MorePolicy, NoTilingPolicy,
                              RegretPolicy, VideoStore, uniform_layout)
from repro_torch.core.cost import CostModel
from repro_torch.core.policies import Policy

CPU = DecodeConfig(device="cpu")
ENC = EncoderConfig(gop=16, qp=8)
MODEL = CostModel(beta=1.4e-8, gamma=1e-5)
MODEL.encode_per_pixel = 3.4e-8
MODEL.encode_per_tile = 1e-4


def fill(store, name, frames, dets, policy=None):
    store.add_video(name, encoder=ENC, policy=policy or NoTilingPolicy(),
                    cost_model=MODEL)
    store.ingest(name, frames)
    store.add_detections(name, {f: d for f, d in enumerate(dets)})


def assert_regions_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1]
        np.testing.assert_array_equal(ra[-1], rb[-1])


def layouts_of(store, name="v"):
    return [(tuple(r.layout.heights), tuple(r.layout.widths), r.epoch)
            for r in store.video(name).store.sots]


class CyclingPolicy(Policy):
    """Test stub: proposes the next layout from a fixed cycle on every
    observation (so repeated observations of one SOT produce *distinct*
    proposals, exercising coalescing)."""

    name = "cycling"
    stateful = False

    def __init__(self, layouts):
        self.layouts = list(layouts)
        self.i = 0

    def observe(self, q, index, store, model):
        lay = self.layouts[self.i % len(self.layouts)]
        self.i += 1
        return lay


# -------------------------------------------------------------- scan path
class TestScanPathOffloading:
    def test_background_queries_never_charged_retile(self, small_video):
        frames, dets = small_video
        # background is the default
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())
        res = [store.scan("v").labels("car").frames(0, 16).execute()
               for _ in range(8)]
        # the scan path never pays re-encode latency ...
        assert all(r.stats.retile_s == 0.0 for r in res)
        st = store.drain_tuner()
        # ... but tuning happened: observations replayed, a retile applied
        assert st.observed == 8 and st.applied >= 1 and st.retile_s > 0
        assert store.video("v").store.sots[0].layout.n_tiles > 1
        store.close()

    def test_inline_preserves_synchronous_semantics(self, small_video):
        frames, dets = small_video
        store = VideoStore(tile_cache_bytes=0, tuning="inline", decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())
        res = [store.scan("v").labels("car").frames(0, 16).execute()
               for _ in range(8)]
        assert any(r.stats.retile_s > 0 for r in res)  # charged to the query
        st = store.tuner_stats()
        assert st.observed == 8 and st.applied >= 1
        # TunerStats mirror the per-query charges exactly
        assert st.retile_s == pytest.approx(
            sum(r.stats.retile_s for r in res))
        assert store.tuner.backlog == 0  # inline never queues

    def test_tuning_off_disables_query_driven_tuning(self, small_video):
        frames, dets = small_video
        pol = RegretPolicy()
        store = VideoStore(tile_cache_bytes=0, tuning="off", decode=CPU)
        fill(store, "v", frames, dets, policy=pol)
        for _ in range(8):
            store.scan("v").labels("car").frames(0, 16).execute()
        store.drain_tuner()  # no-op
        assert not pol.seen  # the policy never saw a query
        assert all(r.layout.n_tiles == 1 for r in store.video("v").store.sots)
        assert store.tuner_stats().observed == 0

    def test_unknown_tuning_mode_rejected(self):
        with pytest.raises(ValueError, match="tuning"):
            VideoStore(tuning="lazy", decode=CPU)

    def test_no_emission_for_inert_policies(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)  # NoTilingPolicy: base observe
        store.scan("v").labels("car").frames(0, 16).execute()
        assert store.tuner_stats().observed == 0  # log never woke the tuner
        assert store.tuner._thread is None


# ------------------------------------------------------------ drain barrier
class TestDrainBarrier:
    def test_drain_is_a_true_barrier(self, small_video):
        frames, dets = small_video
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        pol = RegretPolicy()
        fill(store, "v", frames, dets, policy=pol)
        for _ in range(8):
            store.scan("v").labels("car").frames(0, 32).execute()
        st = store.drain_tuner(timeout=60)
        # after the barrier: log empty, every observation replayed through
        # the policy, surviving proposals applied
        assert store.tuner.backlog == 0
        assert st.observed == 16  # 8 scans x 2 SOTs
        assert pol.seen == {"car"}
        assert st.applied >= 1
        assert store.video("v").store.sots[0].layout.n_tiles > 1

    def test_drain_noop_for_inline_and_off(self, small_video):
        frames, dets = small_video
        for mode in ("inline", "off"):
            store = VideoStore(tuning=mode, decode=CPU)
            fill(store, "v", frames, dets, policy=RegretPolicy())
            store.scan("v").labels("car").frames(0, 16).execute()
            store.drain_tuner(timeout=1)  # returns immediately

    def test_per_query_drain_matches_inline_exactly(self, small_video):
        """With a drain after every query the tuner replays observations at
        the inline cadence, so layouts, epochs, storage bytes, and scan
        results are all identical to tuning='inline'."""
        frames, dets = small_video
        queries = [("car", (0, 32))] * 6 + [("person", (0, 32))] * 4 \
            + [("car", (0, 16))] * 2

        inline = VideoStore(tile_cache_bytes=0, tuning="inline", decode=CPU)
        fill(inline, "v", frames, dets, policy=RegretPolicy())
        ires = [inline.scan("v").labels(l).frames(*fr).execute()
                for l, fr in queries]
        assert any(r.stats.retile_s > 0 for r in ires)

        bg = VideoStore(tile_cache_bytes=0, tuning="background", decode=CPU)
        fill(bg, "v", frames, dets, policy=RegretPolicy())
        bres = []
        for l, fr in queries:
            bres.append(bg.scan("v").labels(l).frames(*fr).execute())
            bg.drain_tuner(timeout=60)
        assert all(r.stats.retile_s == 0 for r in bres)

        assert layouts_of(bg) == layouts_of(inline)
        assert bg.storage_bytes() == inline.storage_bytes()
        for ri, rb in zip(ires, bres):
            assert_regions_equal(ri.regions, rb.regions)
        bg.close(), inline.close()

    def test_overflow_never_evicts_inflight_batch_members(self, small_video):
        """A bounded-log overflow racing an in-flight batch must only drop
        not-yet-taken observations — never batch members (which would make
        the fixed-size post-persist drop destroy a newer, unprocessed
        observation and break the drain() barrier contract)."""
        frames, dets = small_video
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        pol = RegretPolicy()
        fill(store, "v", frames, dets, policy=pol)
        store.tuner.pause()
        for _ in range(3):
            store.scan("v").labels("car").frames(0, 16).execute()
        # take the batch exactly as the worker thread would
        batch = store.tuner._take_batch()
        assert len(batch) == 3 and store.tuner.backlog == 3
        # overflow while the batch is in flight: the new observation must
        # land (and survive) even though log+inflight exceed max_log
        store.tuner.max_log = 1
        store.scan("v").labels("person").frames(0, 16).execute()
        assert store.tuner.backlog == 4
        store.tuner._process_batch(batch)
        # the in-flight batch is gone, the raced observation is intact
        assert store.tuner.backlog == 1
        assert store.tuner._log[0].labels == ("person",)
        assert pol.seen == {"car"}  # batch replayed, new obs not yet
        store.tuner.resume()
        store.drain_tuner(timeout=60)
        assert pol.seen == {"car", "person"}
        store.close()

    def test_bounded_log_drops_oldest(self, small_video):
        frames, dets = small_video
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())
        store.tuner.pause()
        store.tuner.max_log = 4
        for _ in range(6):
            store.scan("v").labels("car").frames(0, 16).execute()
        st = store.tuner_stats()
        assert store.tuner.backlog == 4  # bounded
        assert st.observed == 6 and st.dropped == 2
        store.tuner.resume()
        store.drain_tuner(timeout=60)
        assert store.tuner.backlog == 0


# -------------------------------------------------------------- coalescing
class TestCoalescing:
    def test_applies_only_newest_proposal_per_sot(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        cycle = [uniform_layout(H, W, 2, 2), uniform_layout(H, W, 3, 2),
                 uniform_layout(H, W, 2, 4)]
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=CyclingPolicy(cycle))
        store.tuner.pause()  # build one multi-observation batch
        for _ in range(3):
            store.scan("v").labels("car").frames(0, 16).execute()
        assert store.tuner.backlog == 3
        store.tuner.resume()
        st = store.drain_tuner(timeout=60)
        # three distinct proposals for SOT 0, one re-encode: the newest
        assert st.proposals == 3 and st.coalesced == 2 and st.applied == 1
        rec = store.video("v").store.sots[0]
        assert rec.epoch == 1
        assert rec.layout == cycle[2]

    def test_coalesced_noop_is_skipped(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        lay = uniform_layout(H, W, 2, 2)
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=CyclingPolicy([lay]))
        store.retile("v", 0, lay)  # a foreground retile got there first
        store.scan("v").labels("car").frames(0, 16).execute()
        st = store.drain_tuner(timeout=60)
        assert st.proposals == 1 and st.applied == 0 and st.skipped == 1
        assert store.video("v").store.sots[0].epoch == 1  # no second bump


# ------------------------------------------------- racing scans/sessions
class TestBackgroundRaces:
    def test_scans_racing_background_retiles_bit_identical(self, small_video):
        """Scans racing the tuner's retiles return regions bit-identical to
        a serial inline execution: epoch-consistent fetches + the
        block-aligned codec (reconstruction is layout-invariant)."""
        frames, dets = small_video
        queries = ([("car", (0, 32))] * 4 + [("person", (0, 32))] * 4
                   + [("car", (0, 32))] * 4)

        serial = VideoStore(tile_cache_bytes=0, tuning="inline", decode=CPU)
        fill(serial, "v", frames, dets, policy=RegretPolicy())
        want = [serial.scan("v").labels(l).frames(*fr).execute()
                for l, fr in queries]

        # cache ON: epochs invalidate
        bg = VideoStore(tuning="background", decode=CPU)
        fill(bg, "v", frames, dets, policy=RegretPolicy())
        got = [bg.scan("v").labels(l).frames(*fr).execute()
               for l, fr in queries]  # tuner retiles concurrently
        bg.drain_tuner(timeout=60)
        for w, g in zip(want, got):
            assert_regions_equal(w.regions, g.regions)
        bg.close(), serial.close()

    def test_serve_session_racing_background_tuner(self, small_video):
        frames, dets = small_video
        serial = VideoStore(tile_cache_bytes=0, tuning="inline", decode=CPU)
        fill(serial, "v", frames, dets, policy=RegretPolicy())
        want = serial.scan("v").labels("car").frames(0, 32).execute()

        bg = VideoStore(tuning="background", decode=CPU)
        fill(bg, "v", frames, dets, policy=RegretPolicy())
        with bg.serve() as session:
            futs = [session.submit(
                bg.scan("v").labels("car").frames(0, 32))
                for _ in range(8)]
            results = [f.result(timeout=60) for f in futs]
        bg.drain_tuner(timeout=60)
        for r in results:
            assert r.stats.retile_s == 0.0
            assert_regions_equal(want.regions, r.regions)
        bg.close(), serial.close()

    def test_concurrent_scans_and_drains(self, small_video):
        frames, dets = small_video
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())
        expected = len(
            store.scan("v").labels("car").frames(0, 32).execute().regions)
        errors, results = [], []
        lock = threading.Lock()

        def scan_loop():
            try:
                for _ in range(5):
                    r = store.scan("v").labels("car").frames(0, 32).execute()
                    with lock:
                        results.append(r)
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)

        def drain_loop():
            try:
                for _ in range(5):
                    store.drain_tuner(timeout=60)
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)

        threads = [threading.Thread(target=scan_loop) for _ in range(3)] \
            + [threading.Thread(target=drain_loop)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        store.drain_tuner(timeout=60)
        assert not errors and len(results) == 15
        for r in results:
            assert len(r.regions) == expected
            for f, (y1, x1, y2, x2), px in r.regions:
                assert np.abs(px - frames[f, y1:y2, x1:x2]).mean() < 6.0
        store.close()

    def test_failing_policy_surfaces_at_drain_not_silently(self,
                                                           small_video):
        frames, dets = small_video

        class ExplodingPolicy(Policy):
            name = "exploding"

            def __init__(self):
                self.calls = 0

            def observe(self, q, index, store, model):
                self.calls += 1
                if self.calls == 1:
                    raise RuntimeError("boom")
                return None

        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=ExplodingPolicy())
        store.scan("v").labels("car").frames(0, 16).execute()
        with pytest.raises(RuntimeError, match="boom"):
            store.drain_tuner(timeout=60)
        # the failing batch was dropped, the tuner stays alive
        store.scan("v").labels("car").frames(0, 16).execute()
        store.drain_tuner(timeout=60)  # no error left to re-raise
        assert store.tuner.backlog == 0
        store.close()

    def test_close_flushes_pending_tuning(self, small_video):
        frames, dets = small_video
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        pol = RegretPolicy()
        fill(store, "v", frames, dets, policy=pol)
        store.tuner.pause()  # force the backlog to survive until close
        for _ in range(8):
            store.scan("v").labels("car").frames(0, 16).execute()
        assert store.tuner.backlog == 8
        store.close()  # stops the thread AND flushes the log
        assert store.tuner.backlog == 0
        assert pol.seen == {"car"}
        assert store.video("v").store.sots[0].layout.n_tiles > 1


# ------------------------------------------- manifest v3 / policy state
class TestPolicyStatePersistence:
    def test_regret_state_roundtrips_across_reopen(self, small_video,
                                                   tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), tile_cache_bytes=0,
                           tuning="inline", decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())
        for _ in range(4):
            store.scan("v").labels("car").frames(0, 32).execute()
        store.close()
        state = store.video("v").policy.state_dict()
        assert state["regret"] and state["seen"] == ["car"]

        reopened = VideoStore(store_root=str(tmp_path), tile_cache_bytes=0,
                              decode=CPU)
        pol = reopened.video("v").policy
        # resumes from persisted regret, not cold
        assert pol.state_dict() == state
        assert pol.regret and pol.seen == {"car"}

    def test_more_policy_seen_set_roundtrips(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), tile_cache_bytes=0,
                           tuning="inline", decode=CPU)
        fill(store, "v", frames, dets, policy=MorePolicy())
        store.scan("v").labels("car").frames(0, 16).execute()
        store.scan("v").labels("person").frames(0, 16).execute()
        store.close()
        reopened = VideoStore(store_root=str(tmp_path), decode=CPU)
        assert reopened.video("v").policy.seen == {"car", "person"}

    def test_background_tuner_persists_state(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), tile_cache_bytes=0,
                           decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())
        for _ in range(4):
            store.scan("v").labels("car").frames(0, 32).execute()
        store.drain_tuner(timeout=60)
        # the drain persisted the shard: reopen WITHOUT closing the first
        # store and the replayed observations are already durable
        reopened = VideoStore(store_root=str(tmp_path), decode=CPU)
        assert reopened.video("v").policy.state_dict() == \
            store.video("v").policy.state_dict()
        store.close()

    def test_v2_manifest_migrates_to_v3_on_open(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), tile_cache_bytes=0,
                           tuning="inline", decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())
        for _ in range(8):
            store.scan("v").labels("car").frames(0, 32).execute()
        res1 = store.scan("v").labels("car").frames(0, 32).execute()
        store.close()

        # rewrite the on-disk state in the v2 format (no policy_state)
        shard = tmp_path / "v" / "manifest.json"
        doc = json.loads(shard.read_text())
        doc.pop("policy_state")
        doc["version"] = 2
        shard.write_text(json.dumps(doc))
        cat_path = tmp_path / "catalog.json"
        cat = json.loads(cat_path.read_text())
        cat["version"] = 2
        cat_path.write_text(json.dumps(cat))

        store2 = VideoStore(store_root=str(tmp_path), tile_cache_bytes=0,
                            tuning="inline", decode=CPU)
        # adopted without re-ingest: layouts and pixels survive
        assert layouts_of(store2) == layouts_of(store)
        res2 = store2.scan("v").labels("car").frames(0, 32).execute()
        assert_regions_equal(res1.regions, res2.regions)
        # v2 carried no runtime state: the policy restarts cold ...
        assert store2.video("v").policy.state_dict()["regret"] == []
        # ... and the shards were rewritten as v3 on open
        assert json.loads(shard.read_text())["version"] == 3
        assert json.loads(cat_path.read_text())["version"] == 3
        # round-trip: new state persists in the migrated store
        for _ in range(2):
            store2.scan("v").labels("car").frames(0, 32).execute()
        store2.close()
        store3 = VideoStore(store_root=str(tmp_path), decode=CPU)
        assert store3.video("v").policy.state_dict() == \
            store2.video("v").policy.state_dict()
        assert store3.video("v").policy.seen == {"car"}  # resumed, not cold

    def test_unknown_versions_still_rejected(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        fill(store, "v", frames, dets)
        store.close()
        cat_path = tmp_path / "catalog.json"
        cat = json.loads(cat_path.read_text())
        cat["version"] = 99
        cat_path.write_text(json.dumps(cat))
        with pytest.raises(ValueError, match="version"):
            VideoStore(store_root=str(tmp_path), decode=CPU)


# ------------------------------------------------------ crash-safe ordering
class TestCrashSafeOrdering:
    def test_shard_persisted_before_log_entries_dropped(self, small_video,
                                                        tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), tile_cache_bytes=0,
                           decode=CPU)
        fill(store, "v", frames, dets, policy=RegretPolicy())

        backlog_at_save = []
        orig_save = store.save

        def spy_save(**kw):
            backlog_at_save.append(store.tuner.backlog)
            orig_save(**kw)

        store.save = spy_save
        store.tuner.pause()
        for _ in range(3):
            store.scan("v").labels("car").frames(0, 16).execute()
        assert store.tuner.backlog == 3
        store.tuner.resume()
        store.drain_tuner(timeout=60)
        # the tuner saved while the drained batch was STILL in the log:
        # a crash between replay and persist can never lose observations
        # whose effects were not yet durable
        assert backlog_at_save and backlog_at_save[-1] == 3
        assert store.tuner.backlog == 0
        store.close()


# ------------------------------------------------------ admission control
class TestAdmissionControl:
    """admission="gated": what-if scores gate and rank coalesced winners;
    the default "policy" mode trusts the policies' own gates (unchanged)."""

    def _store(self, frames, dets, policy, **kw):
        store = VideoStore(tile_cache_bytes=0, **kw, decode=CPU)
        fill(store, "v", frames, dets, policy=policy)
        H, W = frames.shape[1:]
        # "small": a 32x32 corner box (tiling pays off); "big": the whole
        # frame (tiling only adds tile-open cost — net-negative)
        store.add_detections("v", {f: [("small", (0, 0, 32, 32))]
                                   for f in range(16)})
        store.add_detections("v", {f: [("big", (0, 0, H, W))]
                                   for f in range(16, 32)})
        return store

    def test_gated_defers_net_negative_proposals(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        store = self._store(frames, dets,
                            CyclingPolicy([uniform_layout(H, W, 2, 2)]),
                            tuner_admission="gated")
        store.tuner.pause()
        for _ in range(3):
            store.scan("v").labels("big").frames(16, 32).execute()
        store.tuner.resume()
        st = store.drain_tuner(timeout=60)
        # splitting a full-frame workload saves no pixels: deferred, and
        # the SOT keeps its layout
        assert st.proposals == 3 and st.coalesced == 2
        assert st.deferred == 1 and st.applied == 0
        assert store.video("v").store.sots[1].layout.n_tiles == 1
        assert store.video("v").store.sots[1].epoch == 0
        store.close()

    def test_policy_mode_applies_unchanged(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        store = self._store(frames, dets,
                            CyclingPolicy([uniform_layout(H, W, 2, 2)]))
        store.scan("v").labels("big").frames(16, 32).execute()
        st = store.drain_tuner(timeout=60)
        # default admission stays with the policy: the proposal applies
        assert st.applied == 1 and st.deferred == 0
        assert store.video("v").store.sots[1].layout.n_tiles == 4
        store.close()

    def test_gated_admits_net_positive_and_ranks_mixed_batch(self,
                                                             small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        # 3x5 grid puts the small box in its own 32x32 tile
        store = self._store(frames, dets,
                            CyclingPolicy([uniform_layout(H, W, 3, 5)]),
                            tuner_admission="gated")
        store.tuner.pause()
        for _ in range(4):    # enough observed workload to beat the gate
            store.scan("v").labels("small").frames(0, 16).execute()
        store.scan("v").labels("big").frames(16, 32).execute()
        store.tuner.resume()
        st = store.drain_tuner(timeout=60)
        # one winner per SOT: the small-ROI one pays off and applies, the
        # full-frame one is deferred
        assert st.applied == 1 and st.deferred == 1
        sots = store.video("v").store.sots
        assert sots[0].layout.n_tiles == 15 and sots[0].epoch == 1
        assert sots[1].layout.n_tiles == 1 and sots[1].epoch == 0
        store.close()

    def test_unknown_admission_mode_rejected(self):
        with pytest.raises(ValueError, match="admission"):
            VideoStore(tuner_admission="yolo", decode=CPU)


# ------------------------------------------------------ proposal feedback
class TestProposalFeedback:
    """Policy.on_superseded/on_applied: a coalesced-away (or deferred, or
    epoch-stale) proposal restores the policy bookkeeping its proposal
    reset, instead of silently losing it."""

    def test_hooks_restore_and_discard(self):
        # unit semantics: on_superseded restores every stacked reset for
        # that layout, on_applied discards them; both tolerate absent keys
        pol = RegretPolicy()
        lay = uniform_layout(96, 160, 2, 2)
        k1, k2 = (0, frozenset({"car"})), (0, frozenset({"person"}))
        pol._pending[(0, lay)] = [(k1, 1.5), (k2, 0.5)]
        pol.on_superseded(0, lay)
        assert pol.regret[k1] == 1.5 and pol.regret[k2] == 0.5
        assert not pol._pending
        pol._pending[(0, lay)] = [(k1, 2.0)]
        pol.on_applied(0, lay)
        assert pol.regret[k1] == 1.5 and not pol._pending  # discarded
        pol.on_applied(0, lay)      # resolving an unknown layout: no-op
        pol.on_superseded(1, lay)

    def test_subsumed_same_layout_proposals_finalize_on_apply(self,
                                                              small_video):
        # re-proposals of the SAME layout within one batch are subsumed by
        # the applied winner: their resets become legitimate (regret ends
        # 0, exactly as inline would leave it), nothing leaks in _pending
        frames, dets = small_video
        pol = RegretPolicy(eta=1e-9)   # proposes on every observation
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=pol)
        store.tuner.pause()
        for _ in range(3):
            store.scan("v").labels("car").frames(0, 16).execute()
        store.tuner.resume()
        st = store.drain_tuner(timeout=60)
        assert st.proposals == 3 and st.coalesced == 2 and st.applied == 1
        key = (0, frozenset({"car"}))
        assert pol.regret.get(key, 0.0) == 0.0
        assert not pol._pending   # every pending proposal resolved
        store.close()

    def test_inline_apply_finalizes_bookkeeping(self, small_video):
        frames, dets = small_video
        pol = RegretPolicy(eta=1e-9)
        store = VideoStore(tile_cache_bytes=0, tuning="inline", decode=CPU)
        fill(store, "v", frames, dets, policy=pol)
        for _ in range(3):
            store.scan("v").labels("car").frames(0, 16).execute()
        # synchronous applies resolve each proposal on the spot
        assert not pol._pending
        store.close()

    def test_deferred_proposal_restores_regret(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        pol = RegretPolicy(eta=1e-9)
        store = VideoStore(tile_cache_bytes=0, tuner_admission="gated",
                           decode=CPU)
        fill(store, "v", frames, dets, policy=pol)
        store.scan("v").labels("car").frames(0, 16).execute()
        st = store.drain_tuner(timeout=60)
        if st.deferred:   # single-query evidence below the what-if gate
            key = (0, frozenset({"car"}))
            assert pol.regret.get(key, 0.0) > 0.0
        assert not pol._pending
        store.close()

    def test_stale_epoch_proposal_superseded_hook(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        proposed = uniform_layout(H, W, 2, 2)
        sneak = uniform_layout(H, W, 3, 3)

        class StaleMaker(Policy):
            """Proposes once, then sneaks a store-level retile in during
            the next observation so the recorded proposal goes stale."""
            name = "stale_maker"
            calls = 0
            superseded: list = []
            applied: list = []

            def observe(self, q, index, store, model):
                StaleMaker.calls += 1
                if StaleMaker.calls == 1:
                    return proposed
                if StaleMaker.calls == 2:
                    store.retile(0, sneak)   # epoch bump behind our back
                return None

            def on_superseded(self, sot_id, layout):
                StaleMaker.superseded.append((sot_id, layout))

            def on_applied(self, sot_id, layout):
                StaleMaker.applied.append((sot_id, layout))

        StaleMaker.superseded, StaleMaker.applied, StaleMaker.calls = [], [], 0
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "v", frames, dets, policy=StaleMaker())
        store.tuner.pause()
        for _ in range(2):
            store.scan("v").labels("car").frames(0, 16).execute()
        store.tuner.resume()
        st = store.drain_tuner(timeout=60)
        # the proposal was never applied (a newer retile won): skipped,
        # with the superseded hook fired so the policy can recover state
        assert st.applied == 0 and st.skipped == 1
        assert StaleMaker.superseded == [(0, proposed)]
        assert StaleMaker.applied == []
        assert store.video("v").store.sots[0].layout == sneak
        store.close()


# ------------------------------------- client threads racing the tuner
def test_threads_and_session_racing_background_tuner(small_video):
    """Three client threads, one pass of the mix each, and a ``serve()``
    session scan while the tuner thread re-encodes
    (``tests/_torch_race.py``): every region bit for bit a serial inline
    store's and within the decode oracle's tolerance, no query charged a
    retile, and an epoch risen.  Whether a retile lands inside a scan is a
    matter of timing here; the card's test demands it."""
    from _torch_race import check, race

    frames, dets = small_video
    check(race(frames, dets, "cpu", max_passes=1))
