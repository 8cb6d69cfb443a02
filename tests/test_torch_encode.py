"""The port's device encoder (``repro_torch.codec.encode.encode_tiles``) and
the ingest/retile slice built on it, against the JAX reference, on the CPU
(the kernels' plain versions).

- ``encode_tiles`` against the reference's numpy ``encode_tile``, tile by
  tile: at least 99.9 % of the ``kq``/``pq`` coefficients equal and the
  PSNR of the numpy-decoded result within 0.1 dB (a flip of a quotient
  within float error of .5 carries through the closed loop of its GOP);
  bit for bit on the ``small_video`` and ``sparse_video`` fixtures.
- Inside the port, a tile encodes to the same bits alone and batched with
  every other tile of its SOT.
- A reference store and a port store ingest the same video and retile it
  under the same inline regret tuning: layout epochs, stored tiles,
  ``size_bytes`` and scan regions agree.
- ``calibrate`` samples the same (pixels, tiles) grid as the reference's
  and fits finite coefficients."""
import importlib

import numpy as np
import pytest

from repro.codec.encode import EncoderConfig as JaxEncoderConfig
from repro.codec.encode import decode_tile as jax_decode_tile
from repro.codec.encode import encode_tile as jax_encode_tile
from repro.codec.psnr import psnr as jax_psnr
from repro.core import CacheConfig as JaxCacheConfig
from repro.core import DecodeConfig as JaxDecodeConfig
from repro.core import RegretPolicy as JaxRegretPolicy
from repro.core import TuningConfig as JaxTuningConfig
from repro.core import VideoStore as JaxVideoStore
from repro.core.cost import CostModel as JaxCostModel
from repro.data.video_gen import generate as jax_generate
from repro.data.video_gen import sparse_spec as jax_sparse_spec
from repro_torch.codec.encode import EncoderConfig, encode_tiles
from repro_torch.core import (CacheConfig, DecodeConfig, RegretPolicy,
                              TuningConfig, VideoStore, fine_grained_layout,
                              uniform_layout)
from repro_torch.core.cost import (CostModel, calibrate, calibrate_encode,
                                   calibrate_io)

ATOL, RTOL = 1e-3, 1e-5
SHARE = 0.999
PSNR_DB = 0.1

jax_calibrate = importlib.import_module("repro.core.calibrate")
port_calibrate = importlib.import_module("repro_torch.core.calibrate")


def _assemble(decoded, rects, shape):
    out = np.zeros(shape, dtype=np.float32)
    for (y1, x1, y2, x2), px in zip(rects, decoded):
        out[:, y1:y2, x1:x2] = px
    return out


def compare_with_reference(frames, rects, gop, qp=8):
    """(equal share of kq/pq, port PSNR, reference PSNR), both decoded by
    the reference's numpy oracle."""
    encs = encode_tiles(frames, rects, EncoderConfig(gop=gop, qp=qp),
                        device="cpu")
    assert len(encs) == len(rects)
    equal = total = 0
    dec_port, dec_ref = [], []
    for (y1, x1, y2, x2), enc in zip(rects, encs):
        ref = jax_encode_tile(np.ascontiguousarray(frames[:, y1:y2, x1:x2]),
                              JaxEncoderConfig(gop=gop, qp=qp))
        for k in ("h", "w", "gop", "qp", "n_frames"):
            assert enc[k] == ref[k], k
        for k in ("kq", "pq"):
            assert enc[k].dtype == np.int16 and enc[k].shape == ref[k].shape
            equal += int((enc[k] == ref[k]).sum())
            total += ref[k].size
        dec_port.append(jax_decode_tile(enc))
        dec_ref.append(jax_decode_tile(ref))
    got = _assemble(dec_port, rects, frames.shape)
    want = _assemble(dec_ref, rects, frames.shape)
    return equal / total, jax_psnr(frames, got), jax_psnr(frames, want), encs


def _video(seed, n_frames, h, w):
    frames, _ = jax_generate(jax_sparse_spec(seed=seed, n_frames=n_frames,
                                             height=h, width=w))
    return frames


@pytest.mark.parametrize("gop", [1, 4, 16])
@pytest.mark.parametrize("h,w,rows,cols", [(96, 160, 1, 1), (96, 160, 2, 3),
                                           (128, 192, 4, 4)])
def test_encode_tiles_matches_encode_tile(h, w, rows, cols, gop):
    frames = _video(h + gop, 16, h, w)
    rects = uniform_layout(h, w, rows, cols).tile_rects()
    share, p_port, p_ref, _ = compare_with_reference(frames, rects, gop)
    assert share >= SHARE
    assert abs(p_port - p_ref) <= PSNR_DB


@pytest.mark.parametrize("gop", [1, 4])
def test_encode_tiles_on_noise_and_uneven_tiles(gop):
    # random noise is the codec's worst case; tiles of uneven sizes and a
    # subset of the frame
    frames = (np.random.default_rng(gop).random((8, 40, 56)) * 255
              ).astype(np.float32)
    rects = [(0, 0, 8, 8), (8, 0, 40, 24), (0, 8, 24, 56), (24, 24, 40, 56)]
    share, p_port, p_ref, _ = compare_with_reference(frames, rects, gop)
    assert share >= SHARE
    assert abs(p_port - p_ref) <= PSNR_DB


@pytest.mark.parametrize("fixture", ["small_video", "sparse_video"])
@pytest.mark.parametrize("rows,cols", [(1, 1), (2, 3)])
def test_encode_tiles_bit_identical_on_fixtures(fixture, rows, cols,
                                                request):
    frames, _ = request.getfixturevalue(fixture)
    h, w = frames.shape[1:]
    rects = uniform_layout(h, w, rows, cols).tile_rects()
    share, p_port, p_ref, encs = compare_with_reference(frames, rects, 16)
    assert share == 1.0 and p_port == p_ref
    for (y1, x1, y2, x2), enc in zip(rects, encs):
        ref = jax_encode_tile(np.ascontiguousarray(frames[:, y1:y2, x1:x2]),
                              JaxEncoderConfig(gop=16, qp=8))
        assert enc["size_bytes"] == ref["size_bytes"]


def test_batched_by_sot_equals_per_tile(sparse_video):
    frames, dets = sparse_video
    h, w = frames.shape[1:]
    boxes = [b for fd in dets[:16] for _, b in fd]
    layouts = [uniform_layout(h, w, 3, 4), fine_grained_layout(h, w, boxes)]
    for gop in (1, 16):
        cfg = EncoderConfig(gop=gop, qp=8)
        for layout in layouts:
            rects = layout.tile_rects()
            batched = encode_tiles(frames, rects, cfg, device="cpu")
            for rect, enc in zip(rects, batched):
                alone, = encode_tiles(frames, [rect], cfg, device="cpu")
                assert enc.keys() == alone.keys()
                for k, v in enc.items():
                    if isinstance(v, np.ndarray):
                        assert np.array_equal(v, alone[k]), k
                    else:
                        assert v == alone[k], k


def test_encode_tiles_rejects_bad_input():
    frames = np.zeros((16, 32, 48), dtype=np.float32)
    cfg = EncoderConfig(gop=16)
    for rect in [(0, 0, 12, 16), (4, 0, 16, 16), (0, 0, 40, 16),
                 (8, 8, 8, 16)]:
        with pytest.raises(ValueError, match="grid"):
            encode_tiles(frames, [rect], cfg, device="cpu")
    with pytest.raises(ValueError, match="GOP"):
        encode_tiles(frames[:12], [(0, 0, 32, 48)], cfg, device="cpu")
    with pytest.raises(ValueError, match="GOP"):
        encode_tiles(frames[:, :30], [(0, 0, 16, 48)], cfg, device="cpu")


# ------------------------------------------------------------ the slice
def _model(cls):
    m = cls(beta=1.4e-8, gamma=1e-5)
    m.encode_per_pixel = 3.4e-8
    m.encode_per_tile = 1e-4
    return m


def test_ingest_and_inline_retile_match_reference(small_video):
    frames, dets = small_video
    ref = JaxVideoStore(decode=JaxDecodeConfig(backend="numpy"),
                        tuning=JaxTuningConfig(mode="inline"),
                        cache=JaxCacheConfig(budget_bytes=0))
    port = VideoStore(decode=DecodeConfig(device="cpu"),
                      tuning=TuningConfig(mode="inline"),
                      cache=CacheConfig(budget_bytes=0))
    for s, policy, model in ((ref, JaxRegretPolicy(), _model(JaxCostModel)),
                             (port, RegretPolicy(), _model(CostModel))):
        s.add_video("cam0", encoder=EncoderConfig(gop=16, qp=8),
                    policy=policy, cost_model=model)
        s.ingest("cam0", frames)
        s.add_detections("cam0", {f: d for f, d in enumerate(dets)})

    def tiles(s):
        ts = s.video("cam0").store
        return {k: v for k, v in ts._mem.items()}, [
            (r.layout.heights, r.layout.widths, r.epoch, r.size_bytes)
            for r in ts.sots]

    def assert_same_tiles():
        (mem_r, recs_r), (mem_p, recs_p) = tiles(ref), tiles(port)
        assert recs_p == recs_r
        assert sorted(mem_p) == sorted(mem_r)
        for key, enc in mem_p.items():
            for k in ("kq", "pq"):
                assert np.array_equal(enc[k], mem_r[key][k]), (key, k)
            assert enc["size_bytes"] == mem_r[key]["size_bytes"], key

    assert_same_tiles()
    retiled = False
    for _ in range(12):
        r = ref.scan("cam0").labels("car").frames(0, 32).execute()
        p = port.scan("cam0").labels("car").frames(0, 32).execute()
        assert len(p.regions) == len(r.regions)
        for gp, gr in zip(p.regions, r.regions):
            assert gp[:-1] == gr[:-1]
            np.testing.assert_allclose(gp[-1], gr[-1], atol=ATOL, rtol=RTOL)
        assert port.epochs("cam0") == ref.epochs("cam0")
        retiled = retiled or p.stats.retile_s > 0
    assert retiled and any(port.epochs("cam0").values())
    assert_same_tiles()
    ref.close()
    port.close()


def test_calibrate_samples_the_reference_grid():
    enc = EncoderConfig(gop=16, qp=8)
    jax_enc = JaxEncoderConfig(gop=16, qp=8)
    tiny = dict(n_frames=16, height=96, width=160)
    runs = {}
    for name, extra in [("measure_decode_samples",
                         dict(seeds=(0,), repeats=1)),
                        ("measure_encode_samples", {}),
                        ("measure_io_samples", dict(repeats=1))]:
        got = getattr(port_calibrate, name)(enc, device="cpu", **tiny,
                                            **extra)
        want = getattr(jax_calibrate, name)(jax_enc, **tiny, **extra)
        assert [row[:-1] for row in got] == [row[:-1] for row in want]
        assert all(np.isfinite(row[-1]) and row[-1] > 0 for row in got)
        runs[name] = got
    model = calibrate(runs["measure_decode_samples"])
    model = calibrate_encode(runs["measure_encode_samples"], model)
    model = calibrate_io(runs["measure_io_samples"], model)
    for k in ("beta", "gamma", "encode_per_pixel", "encode_per_tile",
              "io_per_pixel"):
        v = getattr(model, k)
        assert np.isfinite(v) and v >= 0, k
    assert model.beta > 0 and model.encode_per_pixel > 0


def test_calibrate_needs_a_reachable_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_calibrate.measure_encode_samples(EncoderConfig())
