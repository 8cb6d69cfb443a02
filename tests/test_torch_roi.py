"""The port's ROI-restricted block decode (``tests/test_roi.py`` on
``repro_torch``): bit-identity with full-decode-then-crop across every
execution path, cache block-coverage/superset serving, lazy per-GOP tile
reads, and block-granular accounting.

Every store decodes on the CPU (``DecodeConfig(device="cpu")``) through
the batched path the card runs (``codec/batch.py``, block masks gathered on
the host).  The codec cases run twice: on the numpy ``decode_tile`` oracle,
bit for bit as the reference's, and on ``decode_tile_batch``, bit for bit
against its own full decode and within ``atol=1e-3, rtol=1e-5`` of the
oracle."""
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.codec.batch import decode_tile_batch
from repro_torch.codec.encode import EncoderConfig, decode_tile, encode_tile
from repro_torch.core import (DecodeConfig, NoTilingPolicy, RegretPolicy,
                              TileCache, VideoStore, uniform_layout)
from repro_torch.core.cost import CostModel
from repro_torch.core.layout import TileLayout, block_coverage

ATOL, RTOL = 1e-3, 1e-5
CPU = DecodeConfig(device="cpu")
FULL = DecodeConfig(roi=False, device="cpu")
PATHS = ["oracle", "batched"]
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


def random_boxes(rng, H, W, n):
    """n random (possibly tiny, possibly unaligned) boxes inside HxW."""
    boxes = []
    for _ in range(n):
        h = int(rng.integers(4, 49))
        w = int(rng.integers(4, 57))
        y1 = int(rng.integers(0, H - h))
        x1 = int(rng.integers(0, W - w))
        boxes.append((y1, x1, y1 + h, x1 + w))
    return boxes


def _decode(path, enc, gop_indices=None, frames_within=None, blocks=None):
    """One tile selection on the numpy oracle, or on the batched path (held
    to the oracle at the decode tolerance on the way)."""
    want = decode_tile(enc, gop_indices=gop_indices,
                       frames_within=frames_within, blocks=blocks)
    if path == "oracle":
        return want
    got, = decode_tile_batch([(enc, gop_indices, frames_within, blocks)],
                             device=torch.device("cpu"))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    return got


# ------------------------------------------------------------------- codec
@pytest.mark.parametrize("path", PATHS)
class TestCodecBlocks:
    def test_random_block_subsets_bit_identical(self, sparse_video, path):
        video = sparse_video[0][:32, :48, :64]
        enc = encode_tile(np.ascontiguousarray(video), ENC)
        full = _decode(path, enc)
        nb_r, nb_c = 48 // 8, 64 // 8
        v_full = full.reshape(-1, nb_r, 8, nb_c, 8)
        rng = np.random.default_rng(0)
        for _ in range(20):
            k = int(rng.integers(1, nb_r * nb_c + 1))
            blocks = sorted(rng.choice(nb_r * nb_c, size=k, replace=False))
            roi = _decode(path, enc, blocks=blocks)
            v_roi = roi.reshape(-1, nb_r, 8, nb_c, 8)
            rs, cs = np.divmod(np.asarray(blocks), nb_c)
            np.testing.assert_array_equal(v_roi[:, rs, :, cs],
                                          v_full[:, rs, :, cs])
            # unselected blocks are exactly zero, never stale content
            hole = np.ones((nb_r, nb_c), bool)
            hole[rs, cs] = False
            hr, hc = np.where(hole)
            assert not v_roi[:, hr, :, hc].any()

    def test_blocks_with_gop_subsets_and_partial_frames(self, sparse_video,
                                                        path):
        video = sparse_video[0][:32, :48, :64]
        enc = encode_tile(np.ascontiguousarray(video), ENC)
        ref = _decode(path, enc, gop_indices=[1], frames_within=7)
        roi = _decode(path, enc, gop_indices=[1], frames_within=7,
                      blocks=[0, 13, 40])
        v_ref = ref.reshape(7, 6, 8, 8, 8)
        v_roi = roi.reshape(7, 6, 8, 8, 8)
        rs, cs = np.divmod(np.asarray([0, 13, 40]), 8)
        np.testing.assert_array_equal(v_roi[:, rs, :, cs],
                                      v_ref[:, rs, :, cs])

    def test_empty_and_full_masks(self, sparse_video, path):
        video = sparse_video[0][:16, :32, :32]
        enc = encode_tile(np.ascontiguousarray(video), ENC)
        assert not _decode(path, enc, blocks=[]).any()
        np.testing.assert_array_equal(
            _decode(path, enc, blocks=range(16)), _decode(path, enc))


# ---------------------------------------------------------- block coverage
class TestBlockCoverage:
    def test_masks_cover_exactly_intersected_blocks(self):
        lay = uniform_layout(96, 160, 2, 2)
        boxes = {0: [(10, 12, 30, 41)]}
        cov = block_coverage(lay, boxes)
        for t, mask in cov.items():
            ty1, tx1, ty2, tx2 = lay.tile_rect(t)
            nbx = (tx2 - tx1) // 8
            assert mask is not None
            for b in mask:
                r, c = divmod(b, nbx)
                by1, bx1 = ty1 + r * 8, tx1 + c * 8
                # every selected block overlaps the box
                assert by1 < 30 and by1 + 8 > 10
                assert bx1 < 41 and bx1 + 8 > 12
        # total selected blocks == blocks of the 8-aligned box superset
        n_sel = sum(len(m) for m in cov.values())
        assert n_sel == ((32 - 8) // 8) * ((48 - 8) // 8)

    def test_coverage_agrees_with_blocks_intersecting(self, small_video):
        # block_coverage's vectorized bitmap marking and the per-box
        # blocks_intersecting helper are two spellings of one geometry:
        # pin them to each other over random layouts and boxes
        H, W = 96, 160
        rng = np.random.default_rng(3)
        for _ in range(10):
            lay = uniform_layout(H, W, int(rng.integers(1, 4)),
                                 int(rng.integers(1, 4)))
            boxes = {f: random_boxes(rng, H, W, 2) for f in range(3)}
            cov = block_coverage(lay, boxes)
            want: dict = {}
            for bs in boxes.values():
                for box in bs:
                    for t in lay.tiles_intersecting(box):
                        want.setdefault(t, set()).update(
                            lay.blocks_intersecting(t, box))
            want = {t: s for t, s in want.items() if s}
            assert set(cov) == set(want)
            for t, mask in cov.items():
                full = set(range(lay.tile_blocks(t)))
                assert (full if mask is None else set(mask)) == want[t]

    def test_full_coverage_normalizes_to_none(self):
        lay = TileLayout((32,), (32,))
        cov = block_coverage(lay, {0: [(0, 0, 32, 32)]})
        assert cov == {0: None}


# --------------------------------------------- engine-level bit-identity
class TestRoiBitIdentity:
    def _stores(self, frames, dets, extra, **roi_kw):
        """(full-tile control, ROI store) over identical content."""
        control = VideoStore(tile_cache_bytes=0, decode=FULL)
        fill(control, "v", frames, dets)
        roi = VideoStore(**roi_kw, decode=CPU)
        fill(roi, "v", frames, dets)
        for store in (control, roi):
            for label, by_frame in extra.items():
                store.add_detections(
                    "v", {f: [(label, b) for b in boxes]
                          for f, boxes in by_frame.items()})
        return control, roi

    def test_random_layouts_rois_and_ranges(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        rng = np.random.default_rng(7)
        # synthetic ROI labels with random boxes on random frames
        extra = {}
        for i in range(4):
            by_frame = {}
            for f in sorted(rng.choice(32, size=10, replace=False)):
                by_frame[int(f)] = random_boxes(rng, H, W,
                                                int(rng.integers(1, 3)))
            extra[f"roi{i}"] = by_frame
        control, roi = self._stores(frames, dets, extra)
        # random per-SOT layouts, identical on both stores
        for sot_id in (0, 1):
            r, c = int(rng.integers(1, 4)), int(rng.integers(1, 4))
            lay = uniform_layout(H, W, r, c)
            control.retile("v", sot_id, lay)
            roi.retile("v", sot_id, lay)
        labels = ["car", "person"] + [f"roi{i}" for i in range(4)]
        for trial in range(12):
            label = labels[int(rng.integers(0, len(labels)))]
            lo = int(rng.integers(0, 31))
            hi = int(rng.integers(lo + 1, 33))
            rc = control.scan("v").labels(label).frames(lo, hi).execute()
            rr = roi.scan("v").labels(label).frames(lo, hi).execute()
            assert_regions_equal(rc.regions, rr.regions)

    def test_execute_many_and_serve_match_serial_full(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        rng = np.random.default_rng(11)
        extra = {"roi0": {f: random_boxes(rng, H, W, 2) for f in range(32)}}
        control, roi = self._stores(frames, dets, extra)
        queries = [("roi0", (0, 9)), ("car", (0, 32)), ("roi0", (4, 20)),
                   ("person", (8, 32)), ("roi0", (0, 32))]
        want = [control.scan("v").labels(l).frames(*fr).execute().regions
                for l, fr in queries]
        got = roi.execute_many([roi.scan("v").labels(l).frames(*fr)
                                for l, fr in queries])
        for w, g in zip(want, got):
            assert_regions_equal(w, g.regions)
        with roi.serve() as session:
            futs = [session.submit(roi.scan("v").labels(l).frames(*fr))
                    for l, fr in queries]
            for w, fut in zip(want, futs):
                assert_regions_equal(w, fut.result(timeout=60).regions)

    def test_mid_batch_retile_matches_serial_full(self, small_video):
        frames, dets = small_video
        n = 10  # pushes RegretPolicy over its threshold mid-batch
        control = VideoStore(tile_cache_bytes=0,
                             tuning="inline", decode=FULL)
        fill(control, "v", frames, dets, policy=RegretPolicy())
        want = [control.scan("v").labels("car").frames(0, 32).execute()
                for _ in range(n)]
        assert any(r.stats.retile_s > 0 for r in want)  # it retiled

        roi = VideoStore(tuning="inline", decode=CPU)
        fill(roi, "v", frames, dets, policy=RegretPolicy())
        got = roi.execute_many([roi.scan("v").labels("car").frames(0, 32)
                                for _ in range(n)])
        for w, g in zip(want, got):
            assert_regions_equal(w.regions, g.regions)
        layouts = lambda s: [(r.layout, r.epoch)
                             for r in s.video("v").store.sots]
        assert layouts(control) == layouts(roi)

    def test_stale_roi_plan_recomputes_masks(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        plan = store.scan("v").labels("car").frames(0, 16).explain()
        assert any(ss.blocks_by_tile for ss in plan.sot_scans)
        store.retile("v", 0, uniform_layout(H, W, 2, 2))
        res = store.execute(plan)   # stale epoch: masks recomputed
        control = VideoStore(tile_cache_bytes=0, decode=FULL)
        fill(control, "v", frames, dets)
        control.retile("v", 0, uniform_layout(H, W, 2, 2))
        assert_regions_equal(
            control.scan("v").labels("car").frames(0, 16).execute().regions,
            res.regions)


# ------------------------------------------------------- cache coverage
class TestCacheCoverage:
    def test_unit_block_coverage_semantics(self):
        c = TileCache(budget_bytes=1 << 20)
        arr = np.arange(8 * 16 * 16, dtype=np.float32).reshape(8, 16, 16)
        key = ("v", 0, 0, 0)
        c.put(key, arr, blocks=[0, 1])
        # subset of the mask hits; superset/full/disjoint miss
        assert c.get(key, blocks=[0]) is not None
        assert c.get(key, blocks=[0, 1]) is not None
        assert c.get(key, blocks=[0, 2]) is None
        assert c.get(key) is None                 # full-tile request
        assert c.coverage(key) == (8, frozenset([0, 1]))
        # a narrower put never clobbers wider coverage
        c.put(key, arr, blocks=[3])
        assert c.get(key, blocks=[0]) is not None
        # the union decode replaces it and serves everyone
        c.put(key, arr, blocks=[0, 1, 2, 3])
        assert c.get(key, blocks=[0, 2]) is not None
        # full-tile entries serve any mask
        c.put(key, arr)
        assert c.get(key) is not None
        assert c.get(key, blocks=[2]) is not None
        # ... and are not replaced by partial re-decodes
        c.put(key, arr, blocks=[0])
        assert c.get(key) is not None

    def test_full_tile_entry_serves_sub_roi_without_decode(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        store.add_detections("v", {0: [("roi", (8, 8, 40, 40))]})
        # warm a FULL-tile entry (runtime toggle: plans lowered while the
        # flag is off decode whole tiles), then serve sub-ROI scans from it
        store.roi_decode = False
        store.scan("v").labels("car").frames(0, 16).execute()
        store.roi_decode = True
        decoded = store.video("v").store.tiles_decoded_total
        r = store.scan("v").labels("roi").frames(0, 16).execute()
        assert store.video("v").store.tiles_decoded_total == decoded
        assert r.stats.cache_misses == 0 and r.stats.pixels_decoded == 0
        assert r.regions  # it did serve pixels, from the covering entry

    def test_repeat_roi_scan_decodes_zero_tiles(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        store.add_detections("v", {f: [("roi", (16, 24, 48, 72))]
                                   for f in range(16)})
        q = store.scan("v").labels("roi").frames(0, 16)
        r1 = q.execute()
        assert r1.stats.cache_misses > 0 and r1.stats.pixels_decoded > 0
        decoded = store.video("v").store.tiles_decoded_total
        r2 = q.execute()
        assert store.video("v").store.tiles_decoded_total == decoded
        assert r2.stats.cache_misses == 0 and r2.stats.pixels_decoded == 0
        assert_regions_equal(r1.regions, r2.regions)

    def test_disjoint_roi_unions_masks(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        store.add_detections("v", {0: [("a", (0, 0, 16, 16))],
                                   1: [("b", (64, 96, 88, 144))]})
        ra = store.scan("v").labels("a").frames(0, 16).execute()
        assert ra.stats.cache_misses == 1
        # disjoint ROI in the same tile: miss, re-decode unions the masks
        rb = store.scan("v").labels("b").frames(0, 16).execute()
        assert rb.stats.cache_misses == 1
        decoded = store.video("v").store.tiles_decoded_total
        # now BOTH ROIs are covered by the union entry
        ra2 = store.scan("v").labels("a").frames(0, 16).execute()
        rb2 = store.scan("v").labels("b").frames(0, 16).execute()
        assert store.video("v").store.tiles_decoded_total == decoded
        assert ra2.stats.cache_misses == rb2.stats.cache_misses == 0
        assert_regions_equal(ra.regions, ra2.regions)
        assert_regions_equal(rb.regions, rb2.regions)

    def test_covered_pixels_match_uncached_control(self, small_video):
        # superset-serving never returns pixels outside the covering entry:
        # every region served out of an ROI entry equals a cold decode
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        store.add_detections("v", {f: [("wide", (8, 8, 56, 120)),
                                       ("sub", (16, 16, 40, 70))]
                                   for f in range(8)})
        store.scan("v").labels("wide").frames(0, 8).execute()  # warm ROI
        served = store.scan("v").labels("sub").frames(0, 8).execute()
        assert served.stats.cache_misses == 0
        control = VideoStore(tile_cache_bytes=0, decode=FULL)
        fill(control, "v", frames, dets)
        control.add_detections("v", {f: [("sub", (16, 16, 40, 70))]
                                     for f in range(8)})
        assert_regions_equal(
            control.scan("v").labels("sub").frames(0, 8).execute().regions,
            served.regions)


# ------------------------------------------------------ block accounting
class TestBlockAccounting:
    def test_cold_solo_scan_estimate_equals_actual(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        q = store.scan("v").labels("car").frames(0, 16)
        plan = q.explain()
        base = store.video("v").store.pixels_decoded_total
        res = q.execute()
        actual = store.video("v").store.pixels_decoded_total - base
        assert res.stats.pixels_decoded == actual == plan.est_pixels > 0

    def test_roi_shrinks_estimates_vs_full(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        full = VideoStore(decode=FULL)
        fill(full, "v", frames, dets)
        p_roi = store.scan("v").labels("car").frames(0, 16).explain()
        p_full = full.scan("v").labels("car").frames(0, 16).explain()
        assert 0 < p_roi.est_pixels < p_full.est_pixels
        assert p_roi.est_tiles == p_full.est_tiles


# ---------------------------------------------------- lazy per-GOP reads
class TestLazyTileReads:
    def test_per_gop_members_and_prefix_read(self, sparse_video, tmp_path):
        frames, dets = sparse_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        store.add_video("v", encoder=ENC, cost_model=MODEL, sot_len=64)
        store.ingest("v", frames)
        store.add_detections("v", {f: d for f, d in enumerate(dets)})
        path = tmp_path / "v" / "frames_0-63" / "tile0.npz"
        names = set(zipfile.ZipFile(path).namelist())
        assert {"kq_0.npy", "pq_0.npy", "kq_3.npy", "pq_3.npy"} <= names
        assert "kq.npy" not in names
        ts = store.video("v").store
        # a 1-frame prefix read materializes only GOP 0
        enc = ts._read_tile(ts.sots[0], 0, n_gops=1)
        assert len(enc["kq"]) == 1 and len(enc["pq"]) == 1
        # prefix decode equals the prefix of a full decode
        full = ts.decode_tiles(0, [0])[0]
        part = ts.decode_tiles(0, [0], n_frames=20)[0]
        np.testing.assert_array_equal(part, full[:20])

    def test_legacy_single_member_format_still_reads(self, small_video,
                                                     tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        store.add_video("v", encoder=ENC, cost_model=MODEL)
        store.ingest("v", frames)
        ts = store.video("v").store
        want = ts.decode_tiles(0, [0])[0]
        # rewrite tile 0 of SOT 0 in the pre-PR layout (one member per array)
        path = tmp_path / "v" / "frames_0-15" / "tile0.npz"
        enc = encode_tile(np.ascontiguousarray(frames[:16]), ENC)
        np.savez_compressed(path, kq=enc["kq"], pq=enc["pq"],
                            meta=np.array([enc["h"], enc["w"], enc["gop"],
                                           enc["qp"], enc["n_frames"]]),
                            size=np.array([enc["size_bytes"]]))
        got = ts.decode_tiles(0, [0])[0]
        np.testing.assert_array_equal(want, got)
        roi = ts.decode_tiles(0, [0], blocks={0: (0, 5)})[0]
        v_w, v_r = (a.reshape(16, 12, 8, 20, 8) for a in (want, roi))
        rs, cs = np.divmod(np.asarray([0, 5]), 20)
        np.testing.assert_array_equal(v_r[:, rs, :, cs], v_w[:, rs, :, cs])

    def test_in_memory_prefix_read_slices(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "v", frames, dets)
        ts = store.video("v").store
        enc = ts._read_tile(ts.sots[0], 0, n_gops=1)
        assert len(enc["kq"]) == 1
