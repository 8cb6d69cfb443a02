"""The port's tile store and engine (``repro_torch.core``) against the JAX
reference's, on the CPU (``DecodeConfig(device="cpu")``).

The reference decodes with its numpy oracle backend.  Pixels agree to
``atol=1e-3, rtol=1e-5``; region keys, shapes, dtypes, decode counters and
``ScanStats`` agree exactly.  Inside the port, serial, merged
(``execute_many``) and served scans are bit-identical."""
import numpy as np
import pytest

from repro.core import CacheConfig as JaxCacheConfig
from repro.core import DecodeConfig as JaxDecodeConfig
from repro.core import NoTilingPolicy as JaxNoTilingPolicy
from repro.core import RegretPolicy as JaxRegretPolicy
from repro.core import TuningConfig as JaxTuningConfig
from repro.core import VideoStore as JaxVideoStore
from repro.core import uniform_layout as jax_uniform_layout
from repro.core.cost import CostModel as JaxCostModel
from repro.core.storage import TileStore as JaxTileStore
from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (CacheConfig, DecodeConfig, NoTilingPolicy,
                              RegretPolicy, TuningConfig, VideoStore,
                              uniform_layout)
from repro_torch.core.cost import CostModel
from repro_torch.core.storage import SOTRecord, TileStore

ATOL, RTOL = 1e-3, 1e-5
ENC = EncoderConfig(gop=16, qp=8)
CPU = DecodeConfig(device="cpu")
ORACLE = JaxDecodeConfig(backend="numpy")


def _model(cls):
    m = cls(beta=1.4e-8, gamma=1e-5)
    m.encode_per_pixel = 3.4e-8
    m.encode_per_tile = 1e-4
    return m


def _fill(store, frames, dets, policy, model):
    store.add_video("cam0", encoder=ENC, policy=policy, cost_model=model)
    store.ingest("cam0", frames)
    store.add_detections("cam0", {f: d for f, d in enumerate(dets)})


def _pair(frames, dets, *, regret=False, jax_kw=None, port_kw=None):
    """(reference store on its numpy oracle, port store on the CPU)."""
    ref = JaxVideoStore(decode=ORACLE, **(jax_kw or {}))
    _fill(ref, frames, dets,
          JaxRegretPolicy() if regret else JaxNoTilingPolicy(),
          _model(JaxCostModel))
    port = VideoStore(**{"decode": CPU, **(port_kw or {})})
    _fill(port, frames, dets,
          RegretPolicy() if regret else NoTilingPolicy(), _model(CostModel))
    return ref, port


def assert_regions_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        assert g[-1].dtype == w[-1].dtype and g[-1].shape == w[-1].shape
        np.testing.assert_allclose(g[-1], w[-1], atol=ATOL, rtol=RTOL)


def assert_regions_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1]
        np.testing.assert_array_equal(ra[-1], rb[-1])


def assert_counters_equal(ref, port):
    sa, sb = ref.video("cam0").store, port.video("cam0").store
    assert sa.tiles_decoded_total == sb.tiles_decoded_total
    assert sa.pixels_decoded_total == sb.pixels_decoded_total


def assert_stats_equal(r, p):
    for f in ("tiles_decoded", "pixels_decoded", "cache_hits",
              "cache_misses", "regions"):
        assert getattr(r.stats, f) == getattr(p.stats, f), f


QUERIES = [("car", (0, 32)), ("car", (0, 5)), ("person", (8, 30)),
           ("car", (12, 19))]


# ------------------------------------------------------------- TileStore
class TestTileStore:
    def _pair(self, frames, layout):
        ref = JaxTileStore("v", ENC, sot_len=32, decode_backend="numpy")
        port = TileStore("v", ENC, sot_len=32, device="cpu")
        for ts, lay in ((ref, jax_uniform_layout(*layout)),
                        (port, uniform_layout(*layout))):
            ts.ingest(frames)
            ts.retile(0, lay)
        return ref, port

    def test_decode_tiles_with_depths_and_masks(self, small_video):
        frames, _ = small_video
        H, W = frames.shape[1:]
        ref, port = self._pair(frames, (H, W, 3, 4))
        base_r, base_p = ref.tiles_decoded_total, port.tiles_decoded_total
        depths = {0: 5, 1: 16, 2: 32, 5: 23, 11: 1}
        masks = {0: (0, 1, 7), 2: None, 5: tuple(range(10))}
        tiles = sorted(depths)
        dr = ref.decode_tiles(0, tiles, n_frames=depths, blocks=masks)
        dp = port.decode_tiles(0, tiles, n_frames=depths, blocks=masks)
        assert sorted(dr) == sorted(dp) == tiles
        for t in tiles:
            assert dp[t].shape == dr[t].shape and dp[t].shape[0] == depths[t]
            assert dp[t].dtype == np.float32
            np.testing.assert_allclose(dp[t], dr[t], atol=ATOL, rtol=RTOL)
            # blocks outside an ROI mask stay exactly zero
            if masks.get(t) is not None:
                w8 = dp[t].shape[2] // 8
                view = dp[t].reshape(depths[t], -1, 8, w8, 8)
                outside = sorted(set(range(view.shape[1] * w8)) -
                                 set(masks[t]))
                rs, cs = np.divmod(outside, w8)
                assert not view[:, rs, :, cs].any()
        assert (ref.tiles_decoded_total - base_r ==
                port.tiles_decoded_total - base_p == len(tiles))
        assert ref.pixels_decoded_total == port.pixels_decoded_total

    def test_full_sot_roundtrip(self, small_video):
        frames, _ = small_video
        H, W = frames.shape[1:]
        ref, port = self._pair(frames, (H, W, 2, 2))
        np.testing.assert_allclose(port.decode_full_sot(0),
                                   ref.decode_full_sot(0),
                                   atol=ATOL, rtol=RTOL)

    def test_from_arrays_adopts_reference_tiles(self, small_video):
        frames, _ = small_video
        H, W = frames.shape[1:]
        ref, _ = self._pair(frames, (H, W, 2, 3))
        records = [SOTRecord(r.sot_id, r.frame_start, r.frame_end,
                             uniform_layout(H, W, 2, 3), epoch=r.epoch,
                             size_bytes=r.size_bytes) for r in ref.sots]
        port = TileStore.from_arrays("v", ENC, records, ref._mem,
                                     device="cpu")
        assert port.sot_len == 32
        assert port.sots_in_range(0, 32) == records
        np.testing.assert_allclose(port.decode_full_sot(0),
                                   ref.decode_full_sot(0),
                                   atol=ATOL, rtol=RTOL)

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError, match="decode_backend"):
            TileStore("v", ENC, decode_backend="cuda", device="cpu")
        with pytest.raises(ValueError, match="decode_backend"):
            VideoStore(decode=DecodeConfig(backend="cuda", device="cpu"))


class TestConfig:
    def test_batched_is_the_default_and_numpy_selectable(self):
        assert VideoStore(decode=CPU).decode_backend == "batched"
        s = VideoStore(decode=DecodeConfig(backend="numpy", device="cpu"))
        assert s.decode_backend == "numpy"
        assert s.config()["decode"]["device"] == "cpu"

    def test_env_override_uses_the_ports_own_name(self, monkeypatch):
        monkeypatch.setenv("REPRO_DECODE_BACKEND", "numpy")
        assert VideoStore(decode=CPU).decode_backend == "batched"
        monkeypatch.setenv("REPRO_TORCH_DECODE_BACKEND", "numpy")
        assert VideoStore(decode=CPU).decode_backend == "numpy"
        # an explicit field wins over the environment
        assert VideoStore(decode=DecodeConfig(
            backend="batched", device="cpu")).decode_backend == "batched"


# ---------------------------------------------------------------- engine
class TestEngineParity:
    def test_serial_scans(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        ref, port = _pair(frames, dets)
        ref.retile("cam0", 0, jax_uniform_layout(H, W, 3, 4))
        port.retile("cam0", 0, uniform_layout(H, W, 3, 4))
        for lbl, fr in [("car", (0, 32)), ("person", (3, 21)),
                        ("car", (10, 11))]:
            r = ref.scan("cam0").labels(lbl).frames(*fr).execute()
            p = port.scan("cam0").labels(lbl).frames(*fr).execute()
            assert_regions_close(p.regions, r.regions)
            assert_stats_equal(r, p)
        assert_counters_equal(ref, port)

    def test_execute_many_merged_batch(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        ref, port = _pair(frames, dets)
        ref.retile("cam0", 0, jax_uniform_layout(H, W, 2, 3))
        port.retile("cam0", 0, uniform_layout(H, W, 2, 3))
        rr = ref.execute_many(
            [ref.scan("cam0").labels(l).frames(*f) for l, f in QUERIES])
        pp = port.execute_many(
            [port.scan("cam0").labels(l).frames(*f) for l, f in QUERIES])
        for r, p in zip(rr, pp):
            assert_regions_close(p.regions, r.regions)
            assert_stats_equal(r, p)
        assert_counters_equal(ref, port)

    def test_mid_batch_retile(self, small_video):
        frames, dets = small_video
        ref, port = _pair(
            frames, dets, regret=True,
            jax_kw=dict(tuning=JaxTuningConfig(mode="inline"),
                        cache=JaxCacheConfig(budget_bytes=0)),
            port_kw=dict(tuning=TuningConfig(mode="inline"),
                         cache=CacheConfig(budget_bytes=0)))
        n = 10  # enough repeats to push RegretPolicy over its threshold
        rr = ref.execute_many(
            [ref.scan("cam0").labels("car").frames(0, 32) for _ in range(n)])
        pp = port.execute_many(
            [port.scan("cam0").labels("car").frames(0, 32) for _ in range(n)])
        assert any(p.stats.retile_s > 0 for p in pp)  # it retiled
        for r, p in zip(rr, pp):
            assert_regions_close(p.regions, r.regions)
        layouts = lambda s: [(r.layout.heights, r.layout.widths, r.epoch)
                             for r in s.video("cam0").store.sots]
        assert layouts(ref) == layouts(port)

    def test_serve_session(self, small_video):
        frames, dets = small_video
        ref, port = _pair(frames, dets)
        results = []
        for s in (ref, port):
            with s.serve() as session:
                futs = [session.submit(
                    s.scan("cam0").labels("car").frames(0, 32))
                    for _ in range(6)]
                results.append([f.result(timeout=60) for f in futs])
        for r, p in zip(*results):
            assert_regions_close(p.regions, r.regions)
        assert_counters_equal(ref, port)


class TestPortInternalBitIdentity:
    def test_serial_merged_and_served_scans_identical(self, small_video):
        frames, dets = small_video
        H, W = frames.shape[1:]
        stores = []
        for _ in range(3):
            s = VideoStore(decode=CPU, cache=CacheConfig(budget_bytes=0))
            _fill(s, frames, dets, NoTilingPolicy(), _model(CostModel))
            s.retile("cam0", 0, uniform_layout(H, W, 2, 3))
            stores.append(s)
        serial_s, merged_s, served_s = stores
        serial = [serial_s.scan("cam0").labels(l).frames(*f).execute()
                  for l, f in QUERIES]
        merged = merged_s.execute_many(
            [merged_s.scan("cam0").labels(l).frames(*f) for l, f in QUERIES])
        with served_s.serve() as session:
            futs = [session.submit(served_s.scan("cam0").labels(l)
                                   .frames(*f)) for l, f in QUERIES]
            served = [f.result(timeout=60) for f in futs]
        for a, b, c in zip(serial, merged, served):
            assert_regions_equal(a.regions, b.regions)
            assert_regions_equal(a.regions, c.regions)

    def test_cache_on_and_off_identical(self, small_video):
        frames, dets = small_video
        out = []
        for budget in (0, 64 << 20):
            s = VideoStore(decode=CPU, cache=CacheConfig(budget_bytes=budget))
            _fill(s, frames, dets, NoTilingPolicy(), _model(CostModel))
            out.append([s.scan("cam0").labels(l).frames(*f).execute()
                        for l, f in QUERIES + QUERIES])
        for a, b in zip(*out):
            assert_regions_equal(a.regions, b.regions)


# --------------------------------------------------------------- catalog
def test_port_reopens_and_scans_reference_catalog(small_video, tmp_path):
    frames, dets = small_video
    H, W = frames.shape[1:]
    ref = JaxVideoStore(store_root=str(tmp_path), decode=ORACLE)
    _fill(ref, frames, dets, JaxNoTilingPolicy(), _model(JaxCostModel))
    ref.retile("cam0", 1, jax_uniform_layout(H, W, 2, 2))
    want = [ref.scan("cam0").labels(l).frames(*f).execute()
            for l, f in QUERIES]
    ref.close()
    port = VideoStore(store_root=str(tmp_path), decode=CPU)
    assert port.videos() == ["cam0"]
    assert port.epochs("cam0") == {0: 0, 1: 1}
    got = [port.scan("cam0").labels(l).frames(*f).execute()
           for l, f in QUERIES]
    for r, p in zip(want, got):
        assert_regions_close(p.regions, r.regions)
        assert_stats_equal(r, p)
    port.close()
