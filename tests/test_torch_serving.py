"""The port's serving layer (``tests/test_serving.py`` on ``repro_torch``):
epoch-keyed tile cache, merging scan scheduler, concurrent sessions, and
the scans-racing-a-retile invariants, with every store decoding and
encoding on the CPU (``DecodeConfig(device="cpu")``) through the batched
path the card runs, scan threads and retiles sharing it."""
import threading

import numpy as np
import pytest

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (DecodeConfig, NoTilingPolicy, RegretPolicy,
                              TileCache, VideoStore, uniform_layout)
from repro_torch.core.cost import CostModel

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


# ---------------------------------------------------------------- TileCache
class TestTileCache:
    def test_roundtrip_and_prefix_serving(self):
        c = TileCache(budget_bytes=1 << 20)
        arr = np.arange(16 * 4 * 4, dtype=np.float32).reshape(16, 4, 4)
        key = ("v", 0, 0, 0)
        assert c.get(key) is None
        c.put(key, arr)
        np.testing.assert_array_equal(c.get(key), arr)
        # prefix requests serve views of the cached decode
        np.testing.assert_array_equal(c.get(key, n_frames=8), arr[:8])
        # a deeper request than cached is a miss ...
        c2 = TileCache(budget_bytes=1 << 20)
        c2.put(key, arr[:8])
        assert c2.get(key, n_frames=16) is None
        # ... and the deeper decode replaces the shallower entry
        c2.put(key, arr)
        assert c2.get(key, n_frames=16).shape[0] == 16
        # a shallower put never shrinks an entry
        c2.put(key, arr[:4])
        assert c2.get(key, n_frames=16).shape[0] == 16

    def test_lru_eviction_respects_byte_budget(self):
        arr = np.zeros((4, 8, 8), dtype=np.float32)  # 1 KiB each
        c = TileCache(budget_bytes=3 * arr.nbytes)
        for i in range(3):
            c.put(("v", 0, 0, i), arr)
        c.get(("v", 0, 0, 0))               # tile 0 now most-recent
        c.put(("v", 0, 0, 3), arr)          # over budget: evict LRU (tile 1)
        assert ("v", 0, 0, 1) not in c
        assert all(("v", 0, 0, i) in c for i in (0, 2, 3))
        st = c.stats()
        assert st.evictions == 1 and st.bytes_cached == 3 * arr.nbytes
        # arrays larger than the whole budget are never cached
        big = np.zeros((64, 64, 64), dtype=np.float32)
        c.put(("v", 0, 0, 9), big)
        assert ("v", 0, 0, 9) not in c

    def test_epoch_invalidation(self):
        c = TileCache(budget_bytes=1 << 20)
        arr = np.zeros((4, 4, 4), dtype=np.float32)
        c.put(("v", 0, 0, 0), arr)
        c.put(("v", 0, 1, 0), arr)
        c.put(("v", 1, 0, 0), arr)
        c.put(("w", 0, 0, 0), arr)
        assert c.invalidate("v", 0, before_epoch=1) == 1
        assert ("v", 0, 0, 0) not in c and ("v", 0, 1, 0) in c
        assert c.invalidate(video="v") == 2
        assert len(c) == 1 and ("w", 0, 0, 0) in c

    def test_zero_budget_disables_cache(self):
        c = TileCache(budget_bytes=0)
        arr = np.zeros((4, 4, 4), dtype=np.float32)
        c.put(("v", 0, 0, 0), arr)
        assert c.get(("v", 0, 0, 0)) is None and len(c) == 0


# ------------------------------------------------------------ cached scans
class TestCachedScans:
    def test_repeat_scan_decodes_zero_tiles(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        q = store.scan("cam0").labels("car").frames(0, 32)
        r1 = q.execute()
        decoded_after_first = store.video("cam0").store.tiles_decoded_total
        assert r1.stats.cache_misses > 0
        r2 = q.execute()
        # identical repeat: every tile served from cache, zero decodes
        assert r2.stats.cache_misses == 0
        assert r2.stats.cache_hits == r1.stats.tiles_fetched
        assert r2.stats.cache_hit_rate == 1.0
        assert store.video("cam0").store.tiles_decoded_total == \
            decoded_after_first
        assert_regions_equal(r1.regions, r2.regions)

    def test_cache_disabled_decodes_every_time(self, small_video):
        frames, dets = small_video
        store = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(store, "cam0", frames, dets)
        q = store.scan("cam0").labels("car").frames(0, 32)
        r1, r2 = q.execute(), q.execute()
        assert r1.stats.cache_misses > 0 and r2.stats.cache_misses > 0
        assert r2.stats.cache_hits == 0
        assert_regions_equal(r1.regions, r2.regions)

    def test_deeper_scan_after_shallow_redecodes(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        store.scan("cam0").labels("car").frames(0, 4).execute()
        r = store.scan("cam0").labels("car").frames(0, 32).execute()
        # cached 4-frame decodes cannot serve the 32-frame scan
        assert r.stats.cache_misses > 0
        for f, (y1, x1, y2, x2), px in r.regions:
            assert np.abs(px - frames[f, y1:y2, x1:x2]).mean() < 6.0

    def test_subset_scan_is_all_hits(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        store.scan("cam0").labels("car").frames(0, 32).execute()
        r = store.scan("cam0").labels("car").frames(0, 7).execute()
        # prefix of cached frame depth: served entirely from cache
        assert r.stats.cache_misses == 0 and r.stats.cache_hits > 0
        for f, (y1, x1, y2, x2), px in r.regions:
            assert np.abs(px - frames[f, y1:y2, x1:x2]).mean() < 6.0


# ------------------------------------------------------------ execute_many
class TestExecuteMany:
    def test_overlapping_batch_decodes_shared_tiles_once(self, small_video):
        frames, dets = small_video
        queries = [("car", (0, 32)), ("car", (0, 16)),
                   ("car", (8, 32)), ("person", (0, 32))]

        # cold, no reuse at all
        serial = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(serial, "cam0", frames, dets)
        serial_res = [serial.scan("cam0").labels(l).frames(*fr).execute()
                      for l, fr in queries]

        batch = VideoStore(decode=CPU)
        fill(batch, "cam0", frames, dets)
        base = batch.video("cam0").store.tiles_decoded_total
        batch_res = batch.execute_many(
            [batch.scan("cam0").labels(l).frames(*fr) for l, fr in queries])

        # each shared (sot, tile) decoded exactly once: the batch decodes
        # the union of needed tiles, strictly less than the serial sum
        union = {(ss.sot_id, t)
                 for r in batch_res for ss in r.plan.sot_scans
                 for t in ss.tile_idxs}
        assert batch.video("cam0").store.tiles_decoded_total - base == \
            len(union)
        assert sum(r.stats.cache_misses for r in batch_res) == len(union)
        serial_decodes = sum(r.stats.cache_misses for r in serial_res)
        assert serial_decodes > len(union)
        # per-query regions bit-identical to N serial execute() calls
        for rs, rb in zip(serial_res, batch_res):
            assert_regions_equal(rs.regions, rb.regions)
        # per-query accounting covers exactly the tiles each query needed
        for r in batch_res:
            needed = sum(len(ss.tile_idxs) for ss in r.plan.sot_scans)
            assert r.stats.tiles_fetched == needed

    def test_batch_with_retiling_policy_matches_serial(self, small_video):
        frames, dets = small_video
        n = 10  # enough repeats to push RegretPolicy over its threshold

        # inline tuning on both: this test pins the synchronous mid-batch
        # retile semantics (background tuning is covered in test_tuner.py)
        serial = VideoStore(tile_cache_bytes=0, tuning="inline", decode=CPU)
        fill(serial, "cam0", frames, dets, policy=RegretPolicy())
        serial_res = [
            serial.scan("cam0").labels("car").frames(0, 32).execute()
            for _ in range(n)]
        assert any(r.stats.retile_s > 0 for r in serial_res)  # it retiled

        batch = VideoStore(tuning="inline", decode=CPU)
        fill(batch, "cam0", frames, dets, policy=RegretPolicy())
        batch_res = batch.execute_many(
            [batch.scan("cam0").labels("car").frames(0, 32)
             for _ in range(n)])

        # a mid-batch retile bumps the epoch; later queries re-fetch at the
        # new epoch, so the merged batch stays bit-identical to serial
        for rs, rb in zip(serial_res, batch_res):
            assert_regions_equal(rs.regions, rb.regions)
        layouts = lambda s: [(r.layout, r.epoch)
                             for r in s.video("cam0").store.sots]
        assert layouts(serial) == layouts(batch)

    def test_mixed_depth_batch_matches_serial(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        queries = [("car", (0, 5)), ("person", (0, 14)), ("car", (0, 16))]

        serial = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(serial, "cam0", frames, dets)
        serial.retile("cam0", 0, uniform_layout(H, W, 2, 2))
        sres = [serial.scan("cam0").labels(l).frames(*fr).execute()
                for l, fr in queries]

        batch = VideoStore(decode=CPU)
        fill(batch, "cam0", frames, dets)
        batch.retile("cam0", 0, uniform_layout(H, W, 2, 2))
        # one group, members needing different tiles at different frame
        # depths: the fetch decodes per-tile at that tile's deepest need
        bres = batch.execute_many(
            [batch.scan("cam0").labels(l).frames(*fr) for l, fr in queries])
        for rs, rb in zip(sres, bres):
            assert_regions_equal(rs.regions, rb.regions)

    def test_mixed_decode_false_plans(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        res = store.execute_many([
            store.scan("cam0").labels("car").frames(0, 16),
            store.scan("cam0").labels("car").frames(0, 16).decode(False)])
        assert res[0].regions and res[1].regions == []
        assert res[1].stats.tiles_fetched == 0
        assert res[1].stats.pixels_decoded > 0  # estimates still fill


# ------------------------------------------------------- retile invariants
class TestRetileRaces:
    def test_stale_plan_recomputes_against_new_layout(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        plan = store.scan("cam0").labels("car").frames(0, 16).explain()
        store.retile("cam0", 0, uniform_layout(H, W, 2, 2))
        res = store.execute(plan)  # stale epoch: tiles recomputed
        assert res.stats.regions == plan.n_regions
        for f, (y1, x1, y2, x2), px in res.regions:
            assert np.abs(px - frames[f, y1:y2, x1:x2]).mean() < 6.0

    def test_cache_never_serves_pre_retile_pixels(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        q = store.scan("cam0").labels("car").frames(0, 16)
        q.execute()  # warm the cache at epoch 0
        store.retile("cam0", 0, uniform_layout(H, W, 2, 2))
        # epoch-0 entries are purged, nothing cached at the new epoch
        assert all(k[2] != 0 for k in store.tile_cache._lru
                   if k[:2] == ("cam0", 0))
        r = q.execute()
        assert r.stats.cache_misses > 0  # re-decoded, not served stale
        # pixels must come from the new layout's encode: compare against a
        # control store retiled identically but never cached
        control = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(control, "cam0", frames, dets)
        control.retile("cam0", 0, uniform_layout(H, W, 2, 2))
        assert_regions_equal(control.scan("cam0").labels("car")
                             .frames(0, 16).execute().regions, r.regions)

    def test_concurrent_scans_racing_retiles(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        expected_regions = len(
            store.scan("cam0").labels("car").frames(0, 32).execute().regions)
        errors, results = [], []
        lock = threading.Lock()

        def scan_loop():
            try:
                for _ in range(6):
                    r = store.scan("cam0").labels("car").frames(0, 32) \
                             .execute()
                    with lock:
                        results.append(r)
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)

        def retile_loop():
            try:
                for i in range(4):
                    g = 2 + i % 2
                    store.retile("cam0", i % 2, uniform_layout(H, W, g, g))
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)

        threads = [threading.Thread(target=scan_loop) for _ in range(3)] \
            + [threading.Thread(target=retile_loop)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert len(results) == 18
        for r in results:  # every scan saw a consistent layout + pixels
            assert len(r.regions) == expected_regions
            for f, (y1, x1, y2, x2), px in r.regions:
                assert np.abs(px - frames[f, y1:y2, x1:x2]).mean() < 6.0


# ---------------------------------------------------------- serve sessions
class TestServingSession:
    def test_concurrent_submissions_merge_and_match_serial(self, small_video):
        frames, dets = small_video
        serial = VideoStore(tile_cache_bytes=0, decode=CPU)
        fill(serial, "cam0", frames, dets)
        want = serial.scan("cam0").labels("car").frames(0, 32).execute()

        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        with store.serve() as session:
            futs = [session.submit(
                store.scan("cam0").labels("car").frames(0, 32))
                for _ in range(8)]
            results = [f.result(timeout=60) for f in futs]
        for r in results:
            assert_regions_equal(want.regions, r.regions)
        # across the whole session each tile was decoded at most once
        union = {(ss.sot_id, t) for ss in results[0].plan.sot_scans
                 for t in ss.tile_idxs}
        assert sum(r.stats.cache_misses for r in results) == len(union)

    def test_bad_query_fails_only_its_future(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        with store.serve() as session:
            bad = session.submit(store.scan("cam0").frames(0, 8))  # no labels
            good = session.submit(store.scan("cam0").labels("car"))
            with pytest.raises(ValueError, match="labels"):
                bad.result(timeout=60)
            assert good.result(timeout=60).regions

    def test_submit_after_close_raises(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        session = store.serve()
        session.close()
        with pytest.raises(RuntimeError, match="closed"):
            session.submit(store.scan("cam0").labels("car"))

    def test_cancelled_future_does_not_kill_dispatcher(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        with store.serve() as session:
            doomed = session.submit(store.scan("cam0").labels("car"))
            doomed.cancel()  # may or may not win the race with the dispatcher
            live = session.submit(store.scan("cam0").labels("car"))
            assert live.result(timeout=60).regions  # dispatcher still alive

    def test_store_close_releases_pool_and_flushes(self, small_video,
                                                   tmp_path):
        frames, dets = small_video
        with VideoStore(store_root=str(tmp_path), decode=CPU) as store:
            fill(store, "cam0", frames, dets)
            fill(store, "cam1", frames, dets)
            r1 = store.scan(["cam0", "cam1"]).labels("car").frames(0, 16) \
                      .execute()  # multi-group: spins up the pool
            assert store.scheduler._pool is not None
        assert store.scheduler._pool is None  # close() shut it down
        r2 = store.scan(["cam0", "cam1"]).labels("car").frames(0, 16) \
                  .execute()  # store stays usable after close
        assert len(r2.regions) == len(r1.regions)
