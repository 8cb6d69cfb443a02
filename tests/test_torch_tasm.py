"""The port's VideoStore engine + storage + policies end to end
(``tests/test_tasm.py`` on ``repro_torch``, plus the deprecated TASM shim).
Every store and the shim decode and encode on the CPU
(``DecodeConfig(device="cpu")``) through the batched path the card runs."""
import numpy as np
import pytest

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (TASM, DecodeConfig, KQKOPolicy, LazyPolicy,
                              MorePolicy, NoTilingPolicy, PretileAllPolicy,
                              RegretPolicy, VideoStore, uniform_layout)
from repro_torch.core.cost import CostModel

CPU = DecodeConfig(device="cpu")
FULL = DecodeConfig(roi=False, device="cpu")
ENC = EncoderConfig(gop=16, qp=8)
# deterministic cost model so policy tests do not depend on host speed
MODEL = CostModel(beta=1.4e-8, gamma=1e-5)
MODEL.encode_per_pixel = 3.4e-8
MODEL.encode_per_tile = 1e-4


def make_store(frames, dets, policy=None, **kw):
    # inline tuning: these are policy-convergence tests — layouts must
    # evolve synchronously inside the scans that trigger them
    store = VideoStore(store_root=kw.pop("store_root", None),
                       tuning="inline", decode=CPU)
    store.add_video("v", encoder=ENC, policy=policy or NoTilingPolicy(),
                    cost_model=MODEL, **kw)
    store.ingest("v", frames)
    store.add_detections("v", {f: d for f, d in enumerate(dets)})
    return store


def scan(store, labels, t_range=None, **kw):
    q = store.scan("v").labels(labels)
    if t_range is not None:
        q = q.frames(*t_range)
    return q.execute()


class TestScan:
    def test_scan_returns_correct_pixels(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets)
        res = scan(store, "car", (0, 16))
        assert res.stats.regions > 0
        for f, box, px in res.regions:
            y1, x1, y2, x2 = box
            src = frames[f, y1:y2, x1:x2]
            assert np.abs(px - src).mean() < 6.0  # lossy but close

    def test_scan_empty_label(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets)
        res = scan(store, "unicorn")
        assert res.regions == [] and res.stats.pixels_decoded == 0

    def test_temporal_restriction(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets)
        res = scan(store, "car", (0, 8))
        assert all(f < 8 for f, _, _ in res.regions)

    def test_tiled_scan_decodes_fewer_pixels(self, small_video):
        # under a standard full-tile decoder (DecodeConfig(roi=False))
        # tiling cuts decoded pixels; with ROI-restricted block decode the
        # pixel count is layout-invariant, which test_torch_roi.py covers
        # separately
        frames, dets = small_video

        def full_tile_store(policy=None):
            store = VideoStore(tuning="inline", decode=FULL)
            store.add_video("v", encoder=ENC,
                            policy=policy or NoTilingPolicy(),
                            cost_model=MODEL)
            store.ingest("v", frames)
            store.add_detections("v", {f: d for f, d in enumerate(dets)})
            return store

        s1 = full_tile_store()
        p1 = scan(s1, "car", (0, 16)).stats.pixels_decoded
        s2 = full_tile_store(policy=PretileAllPolicy())
        # re-run ingest-time pretile with detections now present
        e2 = s2.video("v")
        for rec_id, lay in e2.policy.on_ingest(e2.index, e2.store, "v",
                                               frames.shape[1:]).items():
            e2.store.retile(rec_id, lay)
        p2 = scan(s2, "car", (0, 16)).stats.pixels_decoded
        assert p2 < p1
        # ROI decode on the untiled store beats even the tiled full decode
        s3 = make_store(frames, dets)
        p3 = scan(s3, "car", (0, 16)).stats.pixels_decoded
        assert p3 <= p2

    def test_what_if_interface(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets)
        H, W = frames.shape[1:]
        cur = store.what_if("v", "car", {})
        alt = store.what_if("v", "car", {0: uniform_layout(H, W, 2, 2),
                                        1: uniform_layout(H, W, 2, 2)})
        assert alt <= cur  # tiling can only reduce estimated pixels


class TestPolicies:
    def test_regret_retiles_after_repeats(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets, policy=RegretPolicy())
        for _ in range(8):
            scan(store, "car", (0, 16))
        assert any(rec.layout.n_tiles > 1
                   for rec in store.video("v").store.sots[:1])

    def test_regret_respects_eta(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets, policy=RegretPolicy(eta=1e9))
        for _ in range(8):
            scan(store, "car", (0, 16))
        assert all(rec.layout.n_tiles == 1
                   for rec in store.video("v").store.sots)

    def test_lazy_tiles_when_locations_known(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets, policy=LazyPolicy(["car"]))
        scan(store, "car", (0, 16))
        assert store.video("v").store.sots[0].layout.n_tiles > 1

    def test_lazy_waits_for_unknown_objects(self, small_video):
        frames, dets = small_video
        store = VideoStore(tuning="inline", decode=CPU)
        store.add_video("v", encoder=ENC,
                        policy=LazyPolicy(["car", "ghost"]), cost_model=MODEL)
        store.ingest("v", frames)
        store.add_detections("v", {f: d for f, d in enumerate(dets)})
        scan(store, "car", (0, 16))
        # 'ghost' never detected: the SOT must remain untiled
        assert store.video("v").store.sots[0].layout.n_tiles == 1

    def test_more_policy_accumulates_labels(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets, policy=MorePolicy())
        scan(store, "car", (0, 16))
        lay_car = store.video("v").store.sots[0].layout
        scan(store, "person", (0, 16))
        lay_both = store.video("v").store.sots[0].layout
        assert lay_car.n_tiles > 1
        assert lay_both != lay_car  # re-tiled around {car, person}

    def test_kqko_pretile(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        store.add_video("v", encoder=ENC, policy=KQKOPolicy(["car"]),
                        cost_model=MODEL)
        store.add_detections("v", {f: d for f, d in enumerate(dets)})
        store.ingest("v", frames)
        assert any(rec.layout.n_tiles > 1
                   for rec in store.video("v").store.sots)


class TestStorageDisk:
    def test_on_disk_layout(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        store.add_video("v", encoder=ENC, cost_model=MODEL)
        store.ingest("v", frames)
        store.add_detections("v", {f: d for f, d in enumerate(dets)})
        # paper Fig. 1 directory structure
        assert (tmp_path / "v" / "frames_0-15" / "tile0.npz").exists()
        res = scan(store, "car", (0, 16))
        assert res.stats.regions > 0
        # retile rewrites the SOT directory
        H, W = frames.shape[1:]
        store.video("v").store.retile(0, uniform_layout(H, W, 2, 2))
        assert (tmp_path / "v" / "frames_0-15" / "tile3.npz").exists()

    def test_storage_bytes_tracked(self, small_video):
        frames, dets = small_video
        store = make_store(frames, dets)
        assert store.storage_bytes() > 0
        assert store.storage_bytes("v") == store.storage_bytes()


class TestDeprecatedShim:
    """The old single-video TASM facade still works, via VideoStore."""

    def test_shim_warns_and_matches_engine(self, small_video):
        frames, dets = small_video
        with pytest.warns(DeprecationWarning):
            t = TASM("v", ENC, policy=NoTilingPolicy(), cost_model=MODEL,
                     decode=CPU)
        t.ingest(frames)
        t.add_detections({f: d for f, d in enumerate(dets)})
        res_old = t.scan("car", (0, 16))

        store = make_store(frames, dets)
        res_new = scan(store, "car", (0, 16))
        assert len(res_old.regions) == len(res_new.regions)
        for (f1, b1, p1), (f2, b2, p2) in zip(res_old.regions,
                                              res_new.regions):
            assert f1 == f2 and b1 == b2
            np.testing.assert_array_equal(p1, p2)
        assert t.storage_bytes() > 0
        assert t.store.sots and t.index.stats()["entries"] > 0
        assert len(t.history) == 1

    def test_shim_ingest_contract(self, small_video):
        frames, dets = small_video
        with pytest.warns(DeprecationWarning):
            t = TASM("v", ENC, policy=PretileAllPolicy(), cost_model=MODEL,
                     decode=CPU)
        t.add_detections({f: d for f, d in enumerate(dets)})
        st = t.ingest(frames)
        assert st.encode_s > 0 and st.pretile_s > 0
        assert st.total_s == st.encode_s + st.pretile_s
