"""The port's VideoStore engine (``tests/test_engine.py`` on
``repro_torch``): catalog, query builder, plan/execute split, manifest
persistence (reopened in this process and in a fresh one), what-if
interface, estimation-only scans.  Every store decodes and encodes on the
CPU (``DecodeConfig(device="cpu")``) through the batched path the card
runs; results inside one store are held bit for bit, as the reference's
are."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (DecodeConfig, IngestStats, NoTilingPolicy,
                              PretileAllPolicy, RegretPolicy, VideoStore,
                              uniform_layout)
from repro_torch.core.cost import CostModel
from repro_torch.core.layout import partition

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = DecodeConfig(device="cpu")
FULL = DecodeConfig(roi=False, device="cpu")
ENC = EncoderConfig(gop=16, qp=8)
MODEL = CostModel(beta=1.4e-8, gamma=1e-5)
MODEL.encode_per_pixel = 3.4e-8
MODEL.encode_per_tile = 1e-4


def fill(store, name, frames, dets, policy=None):
    store.add_video(name, encoder=ENC, policy=policy or NoTilingPolicy(),
                    cost_model=MODEL)
    store.ingest(name, frames)
    store.add_detections(name, {f: d for f, d in enumerate(dets)})


class TestCatalog:
    def test_catalog_management(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        fill(store, "cam1", frames, dets)
        assert store.videos() == ["cam0", "cam1"]
        assert "cam0" in store and len(store) == 2
        with pytest.raises(ValueError):
            store.add_video("cam0")
        with pytest.raises(KeyError):
            store.video("nope")

    def test_per_video_configuration(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets, policy=RegretPolicy())
        fill(store, "cam1", frames, dets, policy=NoTilingPolicy())
        assert store.video("cam0").policy.name == "incremental_regret"
        assert store.video("cam1").policy.name == "not_tiled"

    def test_auto_register_on_ingest(self, small_video):
        frames, _ = small_video
        store = VideoStore(decode=CPU)
        st = store.ingest("cam0", frames, encoder=ENC, cost_model=MODEL)
        assert isinstance(st, IngestStats)
        assert "cam0" in store and st.encode_s > 0 and st.pretile_s == 0.0

    def test_ingest_rejects_config_for_existing_video(self, small_video):
        frames, _ = small_video
        store = VideoStore(decode=CPU)
        store.add_video("cam0", encoder=ENC, cost_model=MODEL)
        with pytest.raises(ValueError, match="already configured"):
            store.ingest("cam0", frames, encoder=EncoderConfig(gop=32))

    def test_default_policy_not_shared_across_videos(self, small_video):
        frames, dets = small_video
        # inline tuning: policies see scans synchronously
        store = VideoStore(default_encoder=ENC,
                           default_cost_model=MODEL,
                           default_policy=RegretPolicy(),
                           tuning="inline", decode=CPU)
        for name in ("cam0", "cam1"):
            store.ingest(name, frames)
            store.add_detections(name, {f: d for f, d in enumerate(dets)})
        p0, p1 = store.video("cam0").policy, store.video("cam1").policy
        assert p0 is not p1 and p0.name == p1.name == "incremental_regret"
        store.scan("cam0").labels("car").frames(0, 16).execute()
        assert p0.seen and not p1.seen  # cam1's policy saw nothing


class TestQueryBuilder:
    def test_builder_is_immutable_and_forkable(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        base = store.scan("cam0").labels("car")
        early = base.frames(0, 8)
        late = base.frames(8, 16)
        r_early, r_late = early.execute(), late.execute()
        assert all(f < 8 for f, _, _ in r_early.regions)
        assert all(8 <= f < 16 for f, _, _ in r_late.regions)

    def test_requires_labels(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        with pytest.raises(ValueError, match="labels"):
            store.scan("cam0").frames(0, 8).execute()

    def test_bad_range_and_limit(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        with pytest.raises(ValueError):
            store.scan("cam0").frames(8, 8)
        with pytest.raises(ValueError):
            store.scan("cam0").limit(-1)

    def test_limit_truncates_regions_deterministically(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        full = store.scan("cam0").labels("car").frames(0, 32).execute()
        lim = store.scan("cam0").labels("car").frames(0, 32).limit(3).execute()
        assert len(lim.regions) == 3
        for (f1, b1, p1), (f2, b2, p2) in zip(full.regions, lim.regions):
            assert f1 == f2 and b1 == b2
            np.testing.assert_array_equal(p1, p2)

    def test_all_labels_scan(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        res = store.scan("cam0").labels().frames(0, 16).execute()
        per_label = sum(
            len(store.scan("cam0").labels(l).frames(0, 16).execute().regions)
            for l in ("car", "person"))
        assert len(res.regions) == per_label

    def test_all_labels_scan_drives_policies(self, small_video):
        frames, dets = small_video
        store = VideoStore(tuning="inline", decode=CPU)
        pol = RegretPolicy()
        fill(store, "cam0", frames, dets, policy=pol)
        store.scan("cam0").labels().frames(0, 16).execute()
        # the resolved label set must reach the policy, not the () sentinel
        assert pol.seen == {"car", "person"}

    def test_cnf_conjunction(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        res = store.scan("cam0").labels([["car"], ["person"]]).execute()
        # conjunction intersects boxes: strictly fewer regions than union
        union = store.scan("cam0").labels("car", "person").execute()
        assert len(res.regions) <= len(union.regions)


class TestPlanExecute:
    def test_explain_reports_without_decoding(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        plan = store.scan("cam0").labels("car").frames(0, 32).explain()
        assert len(plan.sot_scans) == 2  # 32 frames / 16-frame SOTs
        assert plan.est_pixels > 0 and plan.est_tiles >= 2
        assert plan.est_cost_s > 0
        text = plan.describe()
        assert "SCAN cam0" in text and "sot=" in text
        # explain is pure: no history, no decode counters
        assert store.history == [] and store.video("cam0").history == []

    def test_estimates_match_what_if(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        plan = store.scan("cam0").labels("car").frames(0, 32).explain()
        # plan estimates charge what the engine actually decodes (ROI
        # blocks); what_if's default "tile" granularity models a standard
        # full-tile decoder for layout decisions
        assert plan.est_cost_s == pytest.approx(
            store.what_if("cam0", "car", {}, (0, 32), granularity="block"))
        assert plan.est_cost_s <= store.what_if("cam0", "car", {}, (0, 32))
        # with ROI decode off, plans estimate full-tile decode again
        full = VideoStore(decode=FULL)
        fill(full, "cam0", frames, dets)
        fplan = full.scan("cam0").labels("car").frames(0, 32).explain()
        assert fplan.est_cost_s == pytest.approx(
            full.what_if("cam0", "car", {}, (0, 32)))
        with pytest.raises(ValueError, match="granularity"):
            store.what_if("cam0", "car", {}, (0, 32), granularity="roi")

    def test_decode_false_estimation_only(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        res = store.scan("cam0").labels("car").frames(0, 32) \
                   .decode(False).execute()
        assert res.regions == []
        assert res.stats.pixels_decoded > 0 and res.stats.tiles_decoded > 0
        assert res.stats.decode_s == 0.0
        # estimation-only scans still drive incremental policies
        store2 = VideoStore(tuning="inline", decode=CPU)
        fill(store2, "cam0", frames, dets, policy=RegretPolicy())
        for _ in range(8):
            store2.scan("cam0").labels("car").frames(0, 16) \
                  .decode(False).execute()
        assert any(r.layout.n_tiles > 1
                   for r in store2.video("cam0").store.sots[:1])

    def test_stale_epoch_replans_tiles(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        plan = store.scan("cam0").labels("car").frames(0, 16).explain()
        H, W = frames.shape[1:]
        store.video("cam0").store.retile(0, uniform_layout(H, W, 2, 2))
        res = store.execute(plan)  # plan now stale: epoch bumped
        assert res.stats.regions == plan.n_regions
        for f, box, px in res.regions:
            y1, x1, y2, x2 = box
            assert np.abs(px - frames[f, y1:y2, x1:x2]).mean() < 6.0

    def test_cross_video_scan(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        fill(store, "cam1", frames, dets)
        res = store.scan(["cam0", "cam1"]).labels("car").frames(0, 16) \
                   .execute()
        assert res.regions and len(res.regions[0]) == 4  # video-tagged
        assert set(res.regions_by_video) == {"cam0", "cam1"}
        n0 = len(res.regions_by_video["cam0"])
        n1 = len(res.regions_by_video["cam1"])
        assert n0 == n1 and n0 + n1 == len(res.regions)

    def test_what_if_prefers_tiled_layouts(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        fill(store, "cam0", frames, dets)
        boxes = [b for d in dets[:16] for _, b in d]
        H, W = frames.shape[1:]
        fine = partition(H, W, boxes)
        cur = store.what_if("cam0", "car", {}, (0, 16))
        alt = store.what_if("cam0", "car", {0: fine}, (0, 16))
        assert 0 < alt < cur


class TestManifest:
    def test_reopen_serves_scans_without_reingest(self, small_video,
                                                  tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), tuning="inline",
                           decode=CPU)
        fill(store, "cam0", frames, dets, policy=RegretPolicy())
        for _ in range(8):  # trigger re-tiling so layouts have epoch > 0
            store.scan("cam0").labels("car").frames(0, 32).execute()
        res1 = store.scan("cam0").labels("car").frames(0, 32).execute()
        layouts1 = [(r.layout, r.epoch)
                    for r in store.video("cam0").store.sots]
        bytes1 = store.storage_bytes()
        del store

        store2 = VideoStore(store_root=str(tmp_path), tuning="inline",
                            decode=CPU)
        assert store2.videos() == ["cam0"]
        entry = store2.video("cam0")
        assert entry.policy.name == "incremental_regret"
        assert entry.encoder == ENC
        assert entry.cost_model.beta == MODEL.beta
        assert [(r.layout, r.epoch) for r in entry.store.sots] == layouts1
        assert store2.storage_bytes() == bytes1
        res2 = store2.scan("cam0").labels("car").frames(0, 32).execute()
        assert len(res2.regions) == len(res1.regions)
        for (f1, b1, p1), (f2, b2, p2) in zip(res1.regions, res2.regions):
            assert f1 == f2 and b1 == b2
            np.testing.assert_array_equal(p1, p2)

    def test_reopen_in_a_fresh_process(self, small_video, tmp_path):
        # the same reopen across a process boundary: a child process that
        # never ingested opens the catalog and scans
        frames, dets = small_video
        root = tmp_path / "store"
        store = VideoStore(store_root=str(root), tuning="inline",
                           decode=CPU)
        fill(store, "cam0", frames, dets, policy=RegretPolicy())
        for _ in range(8):
            store.scan("cam0").labels("car").frames(0, 32).execute()
        want = store.scan("cam0").labels("car").frames(0, 32).execute()
        epochs = store.epochs("cam0")
        assert any(epochs.values())  # layouts past epoch 0
        store.close()
        out = tmp_path / "child.npz"
        code = textwrap.dedent(f"""
            import json, numpy as np
            from repro_torch.core import DecodeConfig, VideoStore
            s = VideoStore(store_root={str(root)!r},
                           decode=DecodeConfig(device="cpu"))
            r = s.scan("cam0").labels("car").frames(0, 32).execute()
            np.savez({str(out)!r}, *[px for _, _, px in r.regions])
            print(json.dumps({{"keys": [[f, list(b)] for f, b, _ in
                                        r.regions],
                              "epochs": s.epochs("cam0"),
                              "tiles": r.stats.tiles_decoded}}))
            s.close()
        """)
        env = {"OMP_NUM_THREADS": "2", **os.environ,
               "PYTHONPATH": str(ROOT / "src")}
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        doc = json.loads(proc.stdout)
        assert {int(k): v for k, v in doc["epochs"].items()} == epochs
        assert doc["tiles"] > 0  # decoded from disk, not from a cache
        got = np.load(out)
        assert [(f, tuple(b)) for f, b in doc["keys"]] == \
            [(f, b) for f, b, _ in want.regions]
        for i, (_, _, px) in enumerate(want.regions):
            np.testing.assert_array_equal(got[f"arr_{i}"], px)

    def test_manifest_is_versioned_and_sharded(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        fill(store, "cam0", frames, dets)
        cat = json.loads((tmp_path / "catalog.json").read_text())
        assert cat["version"] == 3 and cat["videos"] == ["cam0"]
        v = json.loads((tmp_path / "cam0" / "manifest.json").read_text())
        assert v["version"] == 3 and v["name"] == "cam0"
        assert "policy_state" in v  # v3: policy runtime state persisted
        assert v["encoder"]["gop"] == 16 and v["sot_len"] == 16
        assert len(v["sots"]) == len(frames) // 16
        assert v["index"]  # semantic-index entries persisted

    def test_mutation_rewrites_only_the_touched_shard(self, small_video,
                                                      tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        fill(store, "cam0", frames, dets)
        fill(store, "cam1", frames, dets)
        other = tmp_path / "cam0" / "manifest.json"
        before = other.stat().st_mtime_ns
        store.add_metadata("cam1", 0, "bus", 1, 1, 9, 9)
        assert other.stat().st_mtime_ns == before  # cam0 shard untouched
        v1 = json.loads((tmp_path / "cam1" / "manifest.json").read_text())
        assert any(lbl == "bus" for _, lbl, _, _ in v1["index"])

    def test_add_metadata_survives_reopen(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        fill(store, "cam0", frames, dets)
        store.add_metadata("cam0", 3, "bicycle", 10, 20, 30, 40)
        del store
        reopened = VideoStore(store_root=str(tmp_path), decode=CPU)
        boxes = reopened.video("cam0").index.boxes_for_label("cam0", "bicycle")
        assert boxes == {3: [(20, 10, 40, 30)]}  # ADDMETADATA is durable

    def test_v1_monolithic_manifest_migrates(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        fill(store, "cam0", frames, dets)
        fill(store, "cam1", frames, dets, policy=PretileAllPolicy())
        res1 = store.scan("cam0").labels("car").frames(0, 32).execute()
        del store
        # rewrite the on-disk state in the v1 monolithic format
        videos = {}
        for name in ("cam0", "cam1"):
            shard = tmp_path / name / "manifest.json"
            doc = json.loads(shard.read_text())
            doc.pop("version"), doc.pop("name")
            videos[name] = doc
            shard.unlink()
        (tmp_path / "catalog.json").unlink()
        (tmp_path / "manifest.json").write_text(
            json.dumps({"version": 1, "videos": videos}))

        # migrates on open
        store2 = VideoStore(store_root=str(tmp_path), decode=CPU)
        assert store2.videos() == ["cam0", "cam1"]
        assert (tmp_path / "catalog.json").exists()
        assert (tmp_path / "cam0" / "manifest.json").exists()
        assert not (tmp_path / "manifest.json").exists()
        assert (tmp_path / "manifest.json.v1.bak").exists()
        res2 = store2.scan("cam0").labels("car").frames(0, 32).execute()
        assert len(res2.regions) == len(res1.regions)  # no re-ingest
        for (f1, b1, p1), (f2, b2, p2) in zip(res1.regions, res2.regions):
            assert f1 == f2 and b1 == b2
            np.testing.assert_array_equal(p1, p2)

    def test_multi_video_manifest(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        fill(store, "cam0", frames, dets)
        fill(store, "cam1", frames, dets, policy=PretileAllPolicy())
        del store
        store2 = VideoStore(store_root=str(tmp_path), decode=CPU)
        assert store2.videos() == ["cam0", "cam1"]
        assert store2.video("cam1").policy.name == "pretile_all"
        r = store2.scan(["cam0", "cam1"]).labels("car").frames(0, 16) \
                  .execute()
        assert len(r.regions_by_video["cam0"]) > 0

    def test_drop_video_removes_data(self, small_video, tmp_path):
        frames, dets = small_video
        store = VideoStore(store_root=str(tmp_path), decode=CPU)
        fill(store, "cam0", frames, dets)
        assert (tmp_path / "cam0").exists()
        store.drop_video("cam0")
        assert not (tmp_path / "cam0").exists()
        assert "cam0" not in VideoStore(store_root=str(tmp_path), decode=CPU)


class TestIngestContract:
    def test_policy_path_counts_pretile_separately(self, small_video):
        frames, dets = small_video
        store = VideoStore(decode=CPU)
        store.add_video("v", encoder=ENC, policy=PretileAllPolicy(),
                        cost_model=MODEL)
        store.add_detections("v", {f: d for f, d in enumerate(dets)})
        st = store.ingest("v", frames)
        assert st.encode_s > 0 and st.pretile_s > 0

    def test_initial_layouts_path_has_zero_pretile(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        boxes = [b for d in dets[:16] for _, b in d]
        store = VideoStore(decode=CPU)
        store.add_video("v", encoder=ENC, cost_model=MODEL)
        st = store.ingest("v", frames,
                          initial_layouts={0: partition(H, W, boxes)})
        assert st.encode_s > 0 and st.pretile_s == 0.0
        assert store.video("v").store.sots[0].layout.n_tiles > 1


class TestReingestGuard:
    def test_second_ingest_of_same_video_rejected(self, small_video):
        frames, _ = small_video
        store = VideoStore(decode=CPU)
        store.add_video("v", encoder=ENC, cost_model=MODEL)
        store.ingest("v", frames)
        with pytest.raises(ValueError, match="already has ingested"):
            store.ingest("v", frames)
