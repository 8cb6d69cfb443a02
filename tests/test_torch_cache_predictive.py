"""The port's workload-predictive cache (``tests/test_cache_predictive.py``
on ``repro_torch``: prefetch, expected-reuse eviction, block-packed ROI
entries) + the unified config surface.

The load-bearing contracts:

- ``eviction="lru"`` (with packing off) reproduces the pre-predictive
  cache byte-for-byte: same eviction order, same counters, same bytes —
  property-tested against a literal re-implementation of the seed code.
- Block-packed entries serve bit-identical pixels through every
  ``get``/``coverage``/``put`` shape (superset serving, never-shrink
  union) while charging fewer bytes.
- The full predictive configuration (prefetch + reuse eviction + packing)
  never changes scan results or per-query ``pixels_decoded`` accounting
  vs a cache-off control — serial, ``execute_many``, ``serve``,
  mid-batch retile, and over a socket — with every store decoding and
  encoding on the CPU (``DecodeConfig(device="cpu")``) through the batched
  path the card runs, prefetch jobs decoding on the worker pool.
- The deprecated ``VideoStore`` kwargs map 1:1 onto the config objects;
  the decode aliases fold into a ``DecodeConfig`` that names no device,
  which means CUDA, so without a card they raise (no CPU fallback).
- The environment names are the port's where it has its own
  (``REPRO_TORCH_DECODE_BACKEND``).
"""
import threading
import warnings
from collections import OrderedDict

import numpy as np
import pytest
import torch

import _hypothesis_compat

_hypothesis_compat.install()

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.codec.encode import EncoderConfig  # noqa: E402
from repro_torch.core import (CacheConfig, DecodeConfig,  # noqa: E402
                              NoTilingPolicy, RegretPolicy,
                              RemoteVideoStore, TileCache, TuningConfig,
                              VideoStore, VideoStoreServer,
                              WorkloadPredictor)
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.tile_cache import _covers  # noqa: E402

CPU = DecodeConfig(device="cpu")

ENC = EncoderConfig(gop=16, qp=8)
MODEL = CostModel(beta=1.4e-8, gamma=1e-5)
MODEL.encode_per_pixel = 3.4e-8
MODEL.encode_per_tile = 1e-4

LRU = CacheConfig(eviction="lru", block_packed=False)


def fill(store, name, frames, dets, policy=None, sot_len=None):
    store.add_video(name, encoder=ENC, policy=policy or NoTilingPolicy(),
                    cost_model=MODEL, sot_len=sot_len)
    store.ingest(name, frames)
    store.add_detections(name, {f: d for f, d in enumerate(dets)})


def assert_regions_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[:-1] == rb[:-1]
        np.testing.assert_array_equal(ra[-1], rb[-1])


@pytest.fixture(scope="module")
def long_video():
    from repro_torch.data.video_gen import VideoSpec, ObjectSpec, generate

    spec = VideoSpec(height=96, width=160, n_frames=256, seed=7,
                     objects=[ObjectSpec("car", 2, (16, 24), 2.0),
                              ObjectSpec("person", 1, (18, 10), 1.0)])
    frames, dets = generate(spec)
    return frames, dets


# =========================================================== lru bit-for-bit
class _SeedLru:
    """The pre-predictive TileCache, verbatim (OrderedDict + popitem):
    the reference model ``eviction="lru"`` must match byte-for-byte."""

    def __init__(self, budget_bytes):
        self.budget_bytes = int(budget_bytes)
        self._lru = OrderedDict()          # key -> (arr, blocks)
        self.hits = self.misses = self.evictions = 0
        self.bytes = 0

    def get(self, key, n_frames=None, blocks=None):
        requested = None if blocks is None else frozenset(blocks)
        e = self._lru.get(key)
        if e is None or (n_frames is not None
                         and e[0].shape[0] < n_frames) \
                or not _covers(e[1], requested):
            self.misses += 1
            return None
        self._lru.move_to_end(key)
        self.hits += 1
        return e[0] if n_frames is None else e[0][:n_frames]

    def put(self, key, arr, blocks=None):
        if arr.nbytes > self.budget_bytes:
            return
        new_blocks = None if blocks is None else frozenset(blocks)
        old = self._lru.pop(key, None)
        if old is not None:
            if old[0].shape[0] > arr.shape[0] \
                    or not _covers(new_blocks, old[1]):
                self._lru[key] = old
                return
            self.bytes -= old[0].nbytes
        self._lru[key] = (arr, new_blocks)
        self.bytes += arr.nbytes
        while self.bytes > self.budget_bytes and self._lru:
            _, victim = self._lru.popitem(last=False)
            self.bytes -= victim[0].nbytes
            self.evictions += 1

    def invalidate(self, before_epoch):
        doomed = [k for k in self._lru if k[2] < before_epoch]
        for k in doomed:
            self.bytes -= self._lru.pop(k)[0].nbytes


def _arr(n_frames, tag):
    a = np.arange(n_frames * 16 * 16, dtype=np.float32)
    return (a + 1000.0 * tag).reshape(n_frames, 16, 16)


# op = ("put", tile, epoch, depth, blocks, tag) | ("get", tile, epoch,
# depth, blocks) | ("invalidate", epoch)
_blocks = st.sampled_from([None, (0,), (1, 2), (0, 1, 2, 3)])
_ops = st.lists(
    st.tuples(st.sampled_from(["put", "put", "get", "invalidate"]),
              st.integers(min_value=0, max_value=5),
              st.integers(min_value=0, max_value=1),
              st.sampled_from([2, 4, 8]),
              _blocks,
              st.integers(min_value=0, max_value=7)),
    min_size=1, max_size=60)


# the shim's @given produces a zero-arg wrapper, so this property test
# lives at module level
@settings(max_examples=60)
@given(ops=_ops)
def test_lru_mode_matches_seed_implementation(ops):
    budget = 3 * _arr(8, 0).nbytes
    cache = TileCache(config=CacheConfig(budget_bytes=budget,
                                         eviction="lru",
                                         block_packed=False))
    seed = _SeedLru(budget)
    for op, tile, epoch, depth, blocks, tag in ops:
        key = ("v", 0, epoch, tile)
        if op == "put":
            a = _arr(depth, tag)
            cache.put(key, a, blocks=blocks)
            seed.put(key, a, blocks=blocks)
        elif op == "get":
            got = cache.get(key, n_frames=depth, blocks=blocks)
            want = seed.get(key, n_frames=depth, blocks=blocks)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)
        else:
            cache.invalidate(before_epoch=epoch)
            seed.invalidate(before_epoch=epoch)
        # eviction ORDER and accounting, not just membership
        assert list(cache._lru) == list(seed._lru)
        st_ = cache.stats()
        assert st_.bytes_cached == seed.bytes
        assert st_.evictions == seed.evictions
        assert (st_.hits, st_.misses) == (seed.hits, seed.misses)


# ============================================================ packed entries
def _masked(n_frames, blocks, tag=0):
    """A canvas whose pixels outside ``blocks`` are zero — exactly what a
    masked decode produces (entry semantics: outside = not content)."""
    a = _arr(n_frames, tag)
    grid = np.zeros((2, 2), dtype=bool)
    grid.flat[list(blocks)] = True
    mask = np.repeat(np.repeat(grid, 8, 0), 8, 1)
    return a * mask


class TestBlockPackedEntries:
    def test_superset_serving_roundtrip(self):
        c = TileCache(config=CacheConfig(budget_bytes=1 << 20,
                                         block_packed=True))
        key = ("v", 0, 0, 0)
        a = _masked(8, {0, 1})
        c.put(key, a, blocks=[0, 1])
        # subset masks and frame prefixes serve bit-identically
        np.testing.assert_array_equal(c.get(key, blocks=[0, 1]), a)
        np.testing.assert_array_equal(c.get(key, 4, blocks=[0]), a[:4])
        # outside the mask, deeper, or full-tile requests miss
        assert c.get(key, blocks=[2]) is None
        assert c.get(key, 16, blocks=[0]) is None
        assert c.get(key) is None
        # packing actually saved budget (2 of 4 blocks resident)
        st_ = c.stats()
        assert 0 < st_.bytes_cached < a.nbytes
        assert st_.packed_bytes_saved == a.nbytes - st_.bytes_cached

    def test_union_widening_never_shrinks(self):
        c = TileCache(config=CacheConfig(budget_bytes=1 << 20,
                                         block_packed=True))
        key = ("v", 0, 0, 0)
        c.put(key, _masked(8, {0}), blocks=[0])
        # the scheduler's covering-miss re-decode: the disjoint union at
        # max depth replaces the entry ...
        u = _masked(8, {0, 3})
        c.put(key, u, blocks=[0, 3])
        assert c.coverage(key) == (8, frozenset({0, 3}))
        np.testing.assert_array_equal(c.get(key, blocks=[3]), u)
        np.testing.assert_array_equal(c.get(key, blocks=[0]), u)
        # ... and narrower or shallower puts are refused
        c.put(key, _masked(4, {1}), blocks=[1])
        c.put(key, _masked(4, {0, 3}), blocks=[0, 3])
        assert c.coverage(key) == (8, frozenset({0, 3}))

    def test_packed_serves_identical_to_unpacked(self):
        packed = TileCache(config=CacheConfig(budget_bytes=1 << 20,
                                              block_packed=True))
        plain = TileCache(config=CacheConfig(budget_bytes=1 << 20,
                                             block_packed=False))
        for tile, blocks in enumerate([{0}, {1, 2}, {0, 1, 2, 3}, None]):
            key = ("v", 0, 0, tile)
            a = _arr(8, tile) if blocks is None else _masked(8, blocks, tile)
            bl = None if blocks is None else sorted(blocks)
            packed.put(key, a, blocks=bl)
            plain.put(key, a, blocks=bl)
            for req in (None, [0], [1], [2, 3]):
                for nf in (None, 2, 8):
                    g1 = packed.get(key, nf, blocks=req)
                    g2 = plain.get(key, nf, blocks=req)
                    assert (g1 is None) == (g2 is None)
                    if g1 is not None:
                        np.testing.assert_array_equal(g1, g2)
        assert packed.stats().bytes_cached < plain.stats().bytes_cached

    def test_full_tile_entries_not_packed(self):
        c = TileCache(config=CacheConfig(budget_bytes=1 << 20,
                                         block_packed=True))
        a = _arr(8, 0)
        c.put(("v", 0, 0, 0), a)
        st_ = c.stats()
        assert st_.bytes_cached == a.nbytes
        assert st_.packed_bytes_saved == 0
        # full-tile serving stays a zero-copy prefix view
        assert c.get(("v", 0, 0, 0), 4).base is not None


# ======================================================= expected-reuse evict
class TestReuseEviction:
    def test_reused_entry_outlives_older_colder(self):
        a = _arr(4, 0)
        c = TileCache(config=CacheConfig(budget_bytes=3 * a.nbytes,
                                         eviction="reuse",
                                         block_packed=False))
        for t in range(3):
            c.put(("v", 0, 0, t), a)
        # tile 0 is the OLDEST but re-accessed twice; pure LRU would keep
        # it only by recency — reuse weighting keeps it by importance
        c.get(("v", 0, 0, 0))
        c.get(("v", 0, 0, 0))
        c.get(("v", 0, 0, 1))          # tile 1 re-accessed once
        c.get(("v", 0, 0, 2))
        c.get(("v", 0, 0, 1))
        # tiles now ordered [0, 2, 1] by recency; weights 2, 1, 2
        c.put(("v", 0, 0, 3), a)       # over budget: evict lowest weight
        assert ("v", 0, 0, 2) not in c
        assert all(("v", 0, 0, t) in c for t in (0, 1, 3))
        assert c.stats().evictions_by_reason == {"budget": 1}

    def test_zero_weight_ties_break_oldest_first(self):
        a = _arr(4, 0)
        c = TileCache(config=CacheConfig(budget_bytes=3 * a.nbytes,
                                         eviction="reuse",
                                         block_packed=False))
        for t in range(3):
            c.put(("v", 0, 0, t), a)
        c.put(("v", 0, 0, 3), a)
        assert ("v", 0, 0, 0) not in c     # all weight 0: LRU order


# ================================================================= prefetch
class TestPredictor:
    def test_monotone_progressions(self):
        p = WorkloadPredictor(depth=2)
        assert p.observe("v", 0) == ()
        assert p.observe("v", 1) == ()
        assert p.observe("v", 2) == (3, 4)       # stride +1
        assert p.observe("v", 2) == ()           # warm repeat: no evidence
        assert p.observe("v", 3) == (4, 5)
        q = WorkloadPredictor(depth=1)
        for sid, want in [(9, ()), (7, ()), (5, (3,)), (3, (1,))]:
            assert q.observe("w", sid) == want   # stride -2
        r = WorkloadPredictor(depth=2)
        for sid, want in [(0, ()), (5, ()), (1, ()), (8, ())]:
            assert r.observe("x", sid) == want   # random access: nothing

    def test_per_video_isolation(self):
        p = WorkloadPredictor(depth=1)
        for v, sid in [("a", 0), ("b", 10), ("a", 1), ("b", 20)]:
            assert p.observe(v, sid) == ()
        assert p.observe("a", 2) == (3,)
        assert p.observe("b", 30) == (40,)

    def test_prefetch_never_evicts_hotter_entry(self):
        a = _arr(4, 0)
        c = TileCache(config=CacheConfig(budget_bytes=2 * a.nbytes,
                                         eviction="reuse",
                                         block_packed=False))
        c.put(("v", 0, 0, 0), a)
        c.put(("v", 0, 0, 1), a)
        c.get(("v", 0, 0, 0))
        c.get(("v", 0, 0, 1))          # both entries now hot (uses > 0)
        assert not c.put(("v", 1, 0, 0), a, prefetch=True)
        assert ("v", 1, 0, 0) not in c           # dropped, not admitted
        assert ("v", 0, 0, 0) in c and ("v", 0, 0, 1) in c
        assert c.stats().prefetch_wasted == 1
        c.get(("v", 0, 0, 1))
        # a cold (never re-accessed) resident IS fair game for a prefetch
        c2 = TileCache(config=CacheConfig(budget_bytes=2 * a.nbytes,
                                          eviction="reuse",
                                          block_packed=False))
        c2.put(("v", 0, 0, 0), a)
        c2.put(("v", 0, 0, 1), a)
        c2.get(("v", 0, 0, 1))
        assert c2.put(("v", 1, 0, 0), a, prefetch=True)
        assert ("v", 0, 0, 0) not in c2          # the cold one went
        assert ("v", 0, 0, 1) in c2
        assert c2.stats().evictions_by_reason == {"prefetch": 1}

    def test_prefetch_hit_and_waste_accounting(self):
        a = _arr(4, 0)
        c = TileCache(config=CacheConfig(budget_bytes=1 << 20,
                                         eviction="reuse",
                                         block_packed=False))
        c.put(("v", 0, 0, 0), a, prefetch=True)
        c.put(("v", 0, 0, 1), a, prefetch=True)
        assert c.get(("v", 0, 0, 0)) is not None
        assert c.get(("v", 0, 0, 0)) is not None  # only the FIRST hit counts
        c.invalidate(video="v", sot_id=0, before_epoch=1)  # 1 never hit
        st_ = c.stats()
        assert st_.prefetch_hits == 1
        assert st_.prefetch_wasted == 1


# =============================================== bit-identity vs cache off
PREDICTIVE = CacheConfig(prefetch=True, prefetch_depth=2,
                         eviction="reuse", block_packed=True)


def _windows(store, n, w=32):
    return [store.scan("cam0").labels("car").frames(i * w, (i + 1) * w)
            for i in range(n)]


class TestBitIdentityVsCacheOff:
    def test_serial_sliding_windows(self, long_video):
        frames, dets = long_video
        pred = VideoStore(cache=PREDICTIVE, decode=CPU)
        ctrl = VideoStore(cache=CacheConfig(budget_bytes=0), decode=CPU)
        fill(pred, "cam0", frames, dets, sot_len=32)
        fill(ctrl, "cam0", frames, dets, sot_len=32)
        try:
            warm_misses = []
            for qp, qc in zip(_windows(pred, 8), _windows(ctrl, 8)):
                rp, rc = qp.execute(), qc.execute()
                assert_regions_equal(rp.regions, rc.regions)
                # a query is only ever charged for decodes that actually
                # ran on its behalf — never more than the cache-off cost
                assert rp.stats.pixels_decoded <= rc.stats.pixels_decoded
                st_ = pred.drain_prefetch(timeout=30)
                warm_misses.append(rp.stats.cache_misses)
            # once the predictor locks on, whole windows decode 0 tiles
            assert warm_misses[-1] == 0 and warm_misses[-2] == 0
            assert st_.prefetch_issued > 0 and st_.prefetch_hits > 0
            doc = pred.stats()["cache"]
            for k in ("prefetch_issued", "prefetch_hits", "prefetch_wasted",
                      "packed_bytes_saved", "evictions_by_reason"):
                assert k in doc
        finally:
            pred.close()
            ctrl.close()

    def test_accounting_sums_to_actual_decode_work(self, long_video):
        """Without prefetch, first-consumer charging must make per-query
        pixels_decoded sum EXACTLY to the store's decoded-pixel total —
        reuse eviction and block packing must not disturb it."""
        frames, dets = long_video
        store = VideoStore(cache=CacheConfig(eviction="reuse",
                                             block_packed=True), decode=CPU)
        fill(store, "cam0", frames, dets, sot_len=32)
        try:
            for q in _windows(store, 6):
                q.execute()
            for q in _windows(store, 6):   # warm repeats
                q.execute()
            charged = sum(s.pixels_decoded for s in store.history)
            actual = store.video("cam0").store.pixels_decoded_total
            assert charged == actual
        finally:
            store.close()

    def test_execute_many_and_serve(self, long_video):
        frames, dets = long_video
        pred = VideoStore(cache=PREDICTIVE, decode=CPU)
        ctrl = VideoStore(cache=CacheConfig(budget_bytes=0), decode=CPU)
        fill(pred, "cam0", frames, dets, sot_len=32)
        fill(ctrl, "cam0", frames, dets, sot_len=32)
        try:
            rb = pred.execute_many(_windows(pred, 8))
            rs = [q.execute() for q in _windows(ctrl, 8)]
            for b, s in zip(rb, rs):
                assert_regions_equal(b.regions, s.regions)
            pred.drain_prefetch(timeout=30)
            with pred.serve() as session:
                futs = [session.submit(q) for q in _windows(pred, 8)]
                for f, s in zip(futs, rs):
                    assert_regions_equal(f.result().regions, s.regions)
        finally:
            pred.close()
            ctrl.close()

    def test_mid_batch_retile(self, long_video):
        """An inline policy re-tiling between plans of one batch must not
        let predictive caching leak pre-retile pixels."""
        frames, dets = long_video
        kw = dict(tuning=TuningConfig(mode="inline"))
        pred = VideoStore(cache=PREDICTIVE, decode=CPU, **kw)
        ctrl = VideoStore(cache=CacheConfig(budget_bytes=0), decode=CPU,
                          **kw)
        for s in (pred, ctrl):
            fill(s, "cam0", frames[:128], dets[:128],
                 policy=RegretPolicy(eta=0.0), sot_len=32)
        try:
            queries = lambda s: [s.scan("cam0").labels(lb).frames(lo, lo + 32)
                                 for lb in ("car", "person")
                                 for lo in (0, 32, 64, 96)]
            rp = pred.execute_many(queries(pred))
            rc = ctrl.execute_many(queries(ctrl))
            for a, b in zip(rp, rc):
                assert_regions_equal(a.regions, b.regions)
            # the eager policy really retiled (epochs moved) ...
            assert any(rec.epoch > 0
                       for rec in pred.video("cam0").store.sots)
            pred.drain_prefetch(timeout=30)
            # ... and no stale-epoch entry survives, prefetched or not
            for key in list(pred.tile_cache._lru):
                video, sot_id, epoch, _ = key
                rec = pred.video(video).store.sots[sot_id]
                assert epoch == rec.epoch
        finally:
            pred.close()
            ctrl.close()

    def test_cross_process(self, tmp_path, long_video):
        frames, dets = long_video
        store = VideoStore(cache=PREDICTIVE, decode=CPU)
        ctrl = VideoStore(cache=CacheConfig(budget_bytes=0), decode=CPU)
        fill(store, "cam0", frames, dets, sot_len=32)
        fill(ctrl, "cam0", frames, dets, sot_len=32)
        sock = str(tmp_path / "tasm.sock")
        server = VideoStoreServer(store, path=sock, owns_store=False).start()
        client = RemoteVideoStore(sock)
        try:
            # the remote twin of the unified surface
            cfg = client.config()
            assert cfg["cache"] == store.cache_config
            assert cfg["tuning"] == store.tuning_config
            last = None
            for i in range(8):
                r = client.scan("cam0").labels("car") \
                          .frames(i * 32, (i + 1) * 32).execute()
                rc = ctrl.scan("cam0").labels("car") \
                         .frames(i * 32, (i + 1) * 32).execute()
                assert_regions_equal(r.regions, rc.regions)
                cs = client.drain_prefetch(timeout=30)
                last = r
            assert last.stats.cache_misses == 0
            assert cs.prefetch_hits > 0
            assert client.stats()["cache"]["prefetch_issued"] > 0
        finally:
            client.close()
            server.stop()
            store.close()
            ctrl.close()


# ========================================================== config surface
class TestConfigSurface:
    def test_deprecated_kwargs_map_1to1(self):
        cases = [
            (dict(tile_cache_bytes=123),
             lambda s: s.cache_config.budget_bytes == 123),
            (dict(tuning="inline"),
             lambda s: s.tuning_config.mode == "inline"),
            (dict(tuner_admission="gated"),
             lambda s: s.tuning_config.admission == "gated"),
        ]
        for kwargs, check in cases:
            with pytest.warns(DeprecationWarning):
                s = VideoStore(**kwargs, decode=CPU)
            try:
                assert check(s), kwargs
            finally:
                s.close()

    def test_deprecated_decode_kwargs_map_1to1(self, monkeypatch):
        """``roi_decode=`` and ``decode_backend=`` fold into a
        ``DecodeConfig`` of their own (passing ``decode=`` beside them is
        an error), and it names no device: that asks for CUDA.  Without a
        card the store refuses to start; the mapping itself is read with
        the device lookup stood in by the test, which records that CUDA
        was asked for."""
        import repro_torch.kernels.decode.ops as ops

        cases = [
            (dict(roi_decode=False), lambda s: s.roi_decode is False),
            (dict(decode_backend="numpy"),
             lambda s: s.decode_backend == "numpy"),
            (dict(decode_backend="batched"),
             lambda s: s.decode_backend == "batched"),
        ]
        if not torch.cuda.is_available():
            for kwargs, _ in cases:
                with pytest.warns(DeprecationWarning):
                    with pytest.raises(RuntimeError, match="cuda"):
                        VideoStore(**kwargs)
        asked = []

        def lookup(device):
            asked.append(str(device))
            return torch.device("cpu")

        monkeypatch.setattr(ops, "resolve_device", lookup)
        for kwargs, check in cases:
            with pytest.warns(DeprecationWarning):
                s = VideoStore(**kwargs)
            try:
                assert check(s), kwargs
            finally:
                s.close()
        assert asked == ["cuda"] * len(cases)

    def test_alias_plus_config_is_an_error(self):
        with pytest.raises(ValueError):
            VideoStore(cache=CacheConfig(), tile_cache_bytes=0, decode=CPU)
        with pytest.raises(ValueError):
            VideoStore(tuning=TuningConfig(), tuner_admission="gated",
                       decode=CPU)
        with pytest.raises(ValueError):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                VideoStore(decode=DecodeConfig(), roi_decode=False)

    def test_env_precedence(self, monkeypatch):
        monkeypatch.setenv("REPRO_CACHE_EVICTION", "lru")
        monkeypatch.setenv("REPRO_CACHE_BYTES", "4096")
        assert CacheConfig().resolve().eviction == "lru"
        assert CacheConfig().resolve().budget_bytes == 4096
        # an explicit field beats the environment
        cfg = CacheConfig(budget_bytes=8192, eviction="reuse").resolve()
        assert (cfg.budget_bytes, cfg.eviction) == (8192, "reuse")
        # the decode backend reads the port's own name, never the
        # reference's (whose default is "numpy"; the port's is "batched")
        monkeypatch.setenv("REPRO_DECODE_BACKEND", "numpy")
        assert CPU.resolve().backend == "batched"
        monkeypatch.setenv("REPRO_TORCH_DECODE_BACKEND", "numpy")
        assert CPU.resolve().backend == "numpy"
        assert DecodeConfig(backend="batched",
                            device="cpu").resolve().backend == "batched"

    def test_docs_roundtrip(self):
        for cfg in (CacheConfig(budget_bytes=1, eviction="lru",
                                prefetch=True, prefetch_depth=3,
                                block_packed=False),
                    TuningConfig(mode="off", admission="gated", max_log=9),
                    DecodeConfig(backend="batched", roi=False,
                                 max_workers=2, device="cpu")):
            assert type(cfg).from_doc(cfg.to_doc()) == cfg

    def test_invalid_values_raise(self):
        with pytest.raises(ValueError):
            CacheConfig(eviction="fifo").resolve()
        with pytest.raises(ValueError):
            TuningConfig(mode="sometimes").resolve()
        with pytest.raises(ValueError):
            DecodeConfig(backend="torch").resolve()
        with pytest.raises(ValueError):
            TileCache(budget_bytes=1, config=CacheConfig())
