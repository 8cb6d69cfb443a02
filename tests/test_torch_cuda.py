"""The CUDA kernels on the card: each against its plain PyTorch version,
block by block independent of the batch, and under the batched decode,
the device encoder, the engine, the video server, the cluster router and
LM serving against the numpy oracles and the plain versions.  Marked
``cuda``; each test skips where no CUDA device is present.  This file
imports no JAX, so it also runs where only the port is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import contextlib
import dataclasses
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.codec.batch import decode_tile_batch
from repro_torch.codec.encode import (EncoderConfig, decode_tile, encode_tile,
                                      encode_tiles)
from repro_torch.codec.psnr import psnr
from repro_torch.core import (CacheConfig, ClusterRouter, DecodeConfig,
                              NoTilingPolicy, RegretPolicy, RemoteVideoStore,
                              TuningConfig, VideoStore, VideoStoreServer,
                              uniform_layout)
from repro_torch.core.cost import CostModel
from repro_torch.data.video_gen import (ObjectSpec, VideoSpec, generate,
                                        sparse_spec)
from repro_torch.configs.base import get_config, make_serve_config
from repro_torch.kernels import dct as dct_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import idct as idct_kernel
from repro_torch.kernels.dct.dct import tables as dct_tables
from repro_torch.kernels.flash_attention.ref import \
    attention_bwd_bf16_mma_ref
from repro_torch.kernels import sad as sad_kernel
from repro_torch.kernels.decode import (LAUNCHES, decode_fused_ref,
                                        decode_gop_blocks)
from repro_torch.models import attention as attention_mod
from repro_torch.models import init_model, loss_fn
from repro_torch.models import moe as moe_mod
from repro_torch.serve import ContinuousBatcher, make_prefill_step
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_train_step

import _torch_families as families

pytestmark = pytest.mark.cuda
ATOL, RTOL = 1e-3, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_stream(rng, n_frames, m, qp):
    """Coefficient stream with the statistics of encoded video: a keyframe
    row whose DC lands in [0, 255] pixels and small AC terms, then sparse
    small residuals."""
    q = np.zeros((n_frames, m, 8, 8), dtype=np.int16)
    dc_max = int(255 * 8 / (16 * max(qp, 1) / 16.0))
    q[0, :, 0, 0] = rng.integers(0, dc_max + 1, size=m)
    q[0, :, :, :] += rng.integers(-3, 4, size=(m, 8, 8)).astype(np.int16)
    if n_frames > 1:
        resid = rng.integers(-2, 3, size=(n_frames - 1, m, 8, 8))
        resid[rng.random(resid.shape) < 0.7] = 0
        q[1:] = resid
    return q


@pytest.mark.parametrize("qp", [4, 8, 12])
@pytest.mark.parametrize("n_frames,m", [(1, 64), (4, 4096), (16, 1000),
                                        (3, 5)] + [
    (f, m) for f in (1, 2, 17) for m in (1, 3, 5, 33, 65)])
def test_kernel_matches_plain_version(cuda, n_frames, m, qp):
    q = torch.from_numpy(random_stream(np.random.default_rng(m + qp),
                                       n_frames, m, qp)).to(cuda)
    before = LAUNCHES.count
    got = decode_gop_blocks(q, qp)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = decode_fused_ref(q, qp)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_kernel_column_independent_of_batch(cuda):
    # a warp owns 4 columns and a thread block 32: the ragged splits cut
    # through both, and F=17 is not a multiple of the frames kept in flight
    for n_frames in (16, 17):
        q = torch.from_numpy(random_stream(np.random.default_rng(1),
                                           n_frames, 777, 8)).to(cuda)
        whole = decode_gop_blocks(q, 8)
        for lo, hi in [(0, 1), (3, 260), (700, 777), (1, 34), (5, 6),
                       (31, 63), (33, 98), (64, 97), (2, 775)]:
            part = decode_gop_blocks(q[:, lo:hi].contiguous(), 8)
            assert torch.equal(part, whole[:, lo:hi])


def test_kernel_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        decode_gop_blocks(torch.zeros((1, 64, 8, 8), device=cuda), 8)
    with pytest.raises(ValueError):
        decode_gop_blocks(torch.zeros((1, 64, 8, 4), dtype=torch.int16,
                                      device=cuda), 8)
    with pytest.raises(ValueError):
        decode_gop_blocks(torch.zeros((1, 8, 64, 8), dtype=torch.int16,
                                      device=cuda).transpose(1, 2), 8)
    # contiguous, but 2 bytes past a 16-byte boundary: the kernel loads
    # each block row as one 16-byte word
    flat = torch.zeros(64 * 64 + 1, dtype=torch.int16, device=cuda)
    view = flat[1:].view(1, 64, 8, 8)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        decode_gop_blocks(view, 8)


def test_batch_on_cuda_matches_oracle(cuda):
    rng = np.random.default_rng(2)
    items = []
    for bh, bw, gop, qp, blocks in [(2, 3, 8, 8, None), (4, 4, 4, 4, (0, 5)),
                                    (1, 1, 8, 12, None), (3, 2, 8, 8, ())]:
        frames = rng.random((2 * gop, bh * 8, bw * 8), dtype=np.float32) * 255
        enc = encode_tile(frames, EncoderConfig(gop=gop, qp=qp))
        items.append((enc, [0, 1], 3 if blocks else None, blocks))
    before = LAUNCHES.count
    got = decode_tile_batch(items, device=cuda)
    assert LAUNCHES.count > before
    for (enc, gsel, fw, blocks), arr in zip(items, got):
        want = decode_tile(enc, gop_indices=gsel, frames_within=fw,
                           blocks=blocks)
        assert arr.shape == want.shape and arr.dtype == want.dtype
        np.testing.assert_allclose(arr, want, atol=ATOL, rtol=RTOL)


def test_store_on_cuda_serial_equals_merged_and_oracle(cuda):
    frames, dets = generate(sparse_spec(seed=4, n_frames=32, height=96,
                                        width=160))
    stores = {}
    for name, dec in [("oracle", DecodeConfig(backend="numpy")),
                      ("serial", DecodeConfig()), ("merged", DecodeConfig())]:
        s = VideoStore(decode=dec, cache=CacheConfig(budget_bytes=0))
        s.ingest("v", frames, detections=dets)
        s.retile("v", 0, uniform_layout(96, 160, 2, 3))
        stores[name] = s
    queries = [("car", (0, 32)), ("person", (3, 21)), ("car", (10, 11))]
    run = lambda s: [s.scan("v").labels(l).frames(*f).execute()
                     for l, f in queries]
    oracle, serial = run(stores["oracle"]), run(stores["serial"])
    merged = stores["merged"].execute_many(
        [stores["merged"].scan("v").labels(l).frames(*f) for l, f in queries])
    for o, a, b in zip(oracle, serial, merged):
        assert len(o.regions) == len(a.regions) == len(b.regions)
        for ro, ra, rb in zip(o.regions, a.regions, b.regions):
            assert ro[:-1] == ra[:-1] == rb[:-1]
            np.testing.assert_array_equal(ra[-1], rb[-1])
            np.testing.assert_allclose(ra[-1], ro[-1], atol=ATOL, rtol=RTOL)
    for s in stores.values():
        s.close()


# ------------------------------------------------------- encode kernels
def pixel_blocks(rng, n, residual):
    """Pixel-scale blocks ([0, 255]) or residuals (small, centred)."""
    if residual:
        return (rng.standard_normal((n, 8, 8)) * 12).astype(np.float32)
    return (rng.random((n, 8, 8)) * 255).astype(np.float32)


#: block counts around a warp's 4 blocks, a thread block's 32, the card's
#: resident thread blocks (past which each warp loops over rounds), and the
#: main path's 32,400
ENCODE_N = [1, 2, 3, 5, 7, 31, 33, 64, 4099, 32400, 131072]


@pytest.mark.parametrize("n", ENCODE_N)
@pytest.mark.parametrize("qp,intra", [(4, True), (8, False), (16, True)])
def test_dct_quant_matches_plain_version(cuda, n, qp, intra):
    x = torch.from_numpy(pixel_blocks(np.random.default_rng(n + qp), n,
                                      not intra)).to(cuda)
    before = dct_kernel.LAUNCHES.count
    got = dct_kernel.dct_quant(x, qp, intra)
    torch.cuda.synchronize()
    assert dct_kernel.LAUNCHES.count == before + 1
    assert got.dtype == torch.int16 and got.shape == x.shape
    want = dct_kernel.dct_quant_ref(x, qp, intra)
    # the kernel pins the plain version's rounding: every product and sum
    # rounded separately in the same order, IEEE division, half to even
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", ENCODE_N)
@pytest.mark.parametrize("qp,intra", [(8, True), (12, False)])
def test_idct_dequant_matches_plain_version(cuda, n, qp, intra):
    q = torch.from_numpy(np.random.default_rng(n).integers(
        -300, 300, size=(n, 8, 8)).astype(np.int16)).to(cuda)
    before = idct_kernel.LAUNCHES.count
    got = idct_kernel.idct_dequant(q, qp, intra)
    torch.cuda.synchronize()
    assert idct_kernel.LAUNCHES.count == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, idct_kernel.idct_dequant_ref(q, qp, intra))


def test_encode_kernels_block_independent_of_batch(cuda):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(pixel_blocks(rng, 1001, False)).to(cuda)
    q = dct_kernel.dct_quant(x, 8, True)
    y = idct_kernel.idct_dequant(q, 8, True)
    # a warp owns 4 blocks and a thread block 32: splits that start and end
    # inside a warp's 4 blocks move every block to another lane group
    for lo, hi in [(0, 1), (3, 4), (5, 260), (998, 1001), (1, 3), (2, 35),
                   (6, 39), (31, 97), (129, 1001)]:
        assert torch.equal(dct_kernel.dct_quant(x[lo:hi].contiguous(), 8,
                                                True), q[lo:hi])
        assert torch.equal(idct_kernel.idct_dequant(q[lo:hi].contiguous(),
                                                    8, True), y[lo:hi])


def test_encode_kernels_reject_bad_input(cuda):
    dct, idct = dct_kernel.dct_quant, idct_kernel.idct_dequant
    with pytest.raises(TypeError):
        dct(torch.zeros((4, 8, 8), dtype=torch.float64, device=cuda), 8, True)
    with pytest.raises(TypeError):
        idct(torch.zeros((4, 8, 8), device=cuda), 8, True)
    for shape in [(4, 8, 4), (4, 64), (0, 8, 8), (2, 4, 8, 8)]:
        with pytest.raises(ValueError):
            dct(torch.zeros(shape, device=cuda), 8, True)
        with pytest.raises(ValueError):
            idct(torch.zeros(shape, dtype=torch.int16, device=cuda), 8, True)
    with pytest.raises(ValueError):
        dct(torch.zeros((8, 8, 4), device=cuda).transpose(1, 2), 8, True)
    with pytest.raises(ValueError):
        idct(torch.zeros((8, 8, 4), dtype=torch.int16,
                         device=cuda).transpose(1, 2), 8, True)


def test_encode_kernels_reject_misaligned_input(cuda):
    # contiguous, but 4 (f32) or 2 (int16) bytes past a 16-byte boundary:
    # a lane loads its block row in 16-byte words
    for fn, dtype in ((dct_kernel.dct_quant, torch.float32),
                      (idct_kernel.idct_dequant, torch.int16)):
        flat = torch.zeros(5 * 64 + 1, dtype=dtype, device=cuda)
        view = flat[1:].view(5, 8, 8)
        assert view.is_contiguous() and view.data_ptr() % 16
        with pytest.raises(ValueError, match="aligned"):
            fn(view, 8, True)


@pytest.mark.parametrize("n", [1, 3, 5, 33, 4099])
def test_encode_kernels_write_nothing_past_n(cuda, n):
    # raw launches through the C entry points into larger buffers filled
    # with a sentinel: the blocks past N keep it
    rng = np.random.default_rng(n)
    x = torch.from_numpy(pixel_blocks(rng, n, True)).to(cuda)
    tab = dct_tables(8, False)
    stream = torch.cuda.current_stream().cuda_stream
    q = torch.full((n + 37, 8, 8), 0x5A5A, dtype=torch.int16, device=cuda)
    assert dct_kernel.LIBRARY.load().dct_quant(
        x.data_ptr(), q.data_ptr(), tab.ctypes.data, n, stream) == 0
    y = torch.full((n + 37, 8, 8), -1234.5, device=cuda)
    assert idct_kernel.LIBRARY.load().idct_dequant(
        q.data_ptr(), y.data_ptr(), tab.ctypes.data, n, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(q[:n], dct_kernel.dct_quant_ref(x, 8, False))
    assert bool((q[n:] == 0x5A5A).all())
    assert torch.equal(y[:n], idct_kernel.idct_dequant_ref(q[:n], 8, False))
    assert bool((y[n:] == -1234.5).all())


def test_dct_quant_clamps_to_int16(cuda):
    # at qp 1 the DC divisor is 1: pixels of +-1e6 put coefficients far
    # past the int16 range, and the kernel clamps them as the plain version
    rng = np.random.default_rng(3)
    x = np.concatenate([np.full((2, 8, 8), 1e6, np.float32),
                        np.full((2, 8, 8), -1e6, np.float32),
                        (rng.standard_normal((61, 8, 8)) * 1e6)
                        .astype(np.float32)])
    x = torch.from_numpy(x).to(cuda)
    for intra in (True, False):
        got = dct_kernel.dct_quant(x, 1, intra)
        torch.cuda.synchronize()
        assert torch.equal(got, dct_kernel.dct_quant_ref(x, 1, intra))
        assert int(got[0, 0, 0]) == 32767 and int(got[2, 0, 0]) == -32768


def _oracle_share_and_psnr(frames, rects, encs, cfg):
    equal = total = 0
    got = np.zeros_like(frames)
    want = np.zeros_like(frames)
    for (y1, x1, y2, x2), enc in zip(rects, encs):
        ref = encode_tile(np.ascontiguousarray(frames[:, y1:y2, x1:x2]), cfg)
        for k in ("kq", "pq"):
            assert enc[k].shape == ref[k].shape and enc[k].dtype == np.int16
            equal += int((enc[k] == ref[k]).sum())
            total += ref[k].size
        got[:, y1:y2, x1:x2] = decode_tile(enc)
        want[:, y1:y2, x1:x2] = decode_tile(ref)
    return equal / total, psnr(frames, got), psnr(frames, want)


def test_device_encode_matches_oracle_and_cpu(cuda):
    frames, _ = generate(sparse_spec(seed=6, n_frames=32, height=192,
                                     width=320))
    cfg = EncoderConfig(gop=16, qp=8)
    rects = uniform_layout(192, 320, 3, 4).tile_rects()
    before = dct_kernel.LAUNCHES.count, idct_kernel.LAUNCHES.count
    encs = encode_tiles(frames, rects, cfg, device=cuda)
    assert dct_kernel.LAUNCHES.count - before[0] == 32
    assert idct_kernel.LAUNCHES.count - before[1] == 30
    share, p_dev, p_ref = _oracle_share_and_psnr(frames, rects, encs, cfg)
    assert share >= 0.999 and abs(p_dev - p_ref) <= 0.1
    # same arithmetic as the plain versions on the CPU, block by block
    for enc, cpu in zip(encs, encode_tiles(frames, rects, cfg,
                                           device="cpu")):
        assert np.array_equal(enc["kq"], cpu["kq"])
        assert np.array_equal(enc["pq"], cpu["pq"])
        assert enc["size_bytes"] == cpu["size_bytes"]


def test_store_ingest_and_retile_encode_on_cuda(cuda):
    # the small_video fixture's spec: its cars make RegretPolicy retile
    frames, dets = generate(VideoSpec(
        height=96, width=160, n_frames=32, seed=5,
        objects=[ObjectSpec("car", 2, (16, 24), 2.0),
                 ObjectSpec("person", 1, (18, 10), 1.0)]))
    cfg = EncoderConfig(gop=16, qp=8)
    for mode in ("inline", "background"):
        store = VideoStore(decode=DecodeConfig(device=str(cuda)),
                           tuning=TuningConfig(mode=mode),
                           cache=CacheConfig(budget_bytes=0))
        model = CostModel(beta=1.4e-8, gamma=1e-5)
        model.encode_per_pixel, model.encode_per_tile = 3.4e-8, 1e-4
        store.add_video("v", encoder=cfg, policy=RegretPolicy(),
                        cost_model=model)
        before = dct_kernel.LAUNCHES.count
        store.ingest("v", frames)
        assert dct_kernel.LAUNCHES.count - before == 32
        store.add_detections("v", {f: d for f, d in enumerate(dets)})
        before = dct_kernel.LAUNCHES.count, idct_kernel.LAUNCHES.count
        for _ in range(12):
            store.scan("v").labels("car").frames(0, 32).execute()
            store.drain_tuner(timeout=120)
            if any(store.epochs("v").values()):
                break
        assert any(store.epochs("v").values()), mode
        assert dct_kernel.LAUNCHES.count > before[0]
        assert idct_kernel.LAUNCHES.count > before[1]
        ts = store.video("v").store
        for rec in ts.sots:
            rects = rec.layout.tile_rects()
            encs = [ts._read_tile(rec, i) for i in range(len(rects))]
            src = frames[rec.frame_start:rec.frame_end]
            if rec.epoch == 0:
                share, p_dev, p_ref = _oracle_share_and_psnr(src, rects,
                                                             encs, cfg)
                assert share >= 0.999 and abs(p_dev - p_ref) <= 0.1
        oracle = np.zeros_like(frames)
        for rec in ts.sots:
            for i, (y1, x1, y2, x2) in enumerate(rec.layout.tile_rects()):
                oracle[rec.frame_start:rec.frame_end, y1:y2, x1:x2] = \
                    decode_tile(ts._read_tile(rec, i))
        res = store.scan("v").labels("car").frames(0, 32).execute()
        assert res.regions
        for frame, (y1, x1, y2, x2), px in res.regions:
            np.testing.assert_allclose(px, oracle[frame, y1:y2, x1:x2],
                                       atol=ATOL, rtol=RTOL)
        store.close()


# ------------------------------------------------------------ flash_attention
#: the reference's tolerances (tests/test_kernels.py): f32 2e-5, bf16 2e-2
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(seed, b, h, kv, s, d, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 7, 100, 256, 15, 17, 63, 65, 257])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain_version(cuda, dtype, d, s, causal):
    q, k, v = _qkv(s + d, 2, 6, 2, s, d, dtype, cuda)
    before = flash_kernel.LAUNCHES.count
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_kernel.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=0)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 3, 7, 8])
@pytest.mark.parametrize("s", [1, 15, 17, 63, 65, 257])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_query_groups(cuda, g, d, s, causal):
    # G = H / KV query heads on one KV head, at lengths around the 64-row
    # tiles of the tensor-core path
    q, k, v = _qkv(s + d + g, 2, 2 * g, 2, s, d, torch.bfloat16, cuda)
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    want = flash_kernel.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("s", [1, 15, 17, 63, 65, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_writes_no_row_past_s(cuda, dtype, s):
    """Rows >= S of a ragged tile are not written: the raw launch into a
    buffer pre-filled past its end leaves the fill alone, and a causal
    call of length S equals the first S rows of a longer one exactly."""
    b, h, kv, d = 2, 6, 2, 64
    q, k, v = _qkv(s, b, h, kv, s + 64, d, dtype, cuda)
    q, k, v = (x[:, :, :s].contiguous() for x in (q, k, v))
    fill = torch.full((b * h * s * d + 64 * d,), 7.0, dtype=dtype,
                      device=cuda)
    lib = flash_kernel.LIBRARY.load()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), fill.data_ptr(), None, b,
        h, kv, s, s, d, d, flash_kernel.flash.DTYPES[dtype], 1, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert bool((fill[b * h * s * d:] == 7.0).all())
    out = flash_kernel.flash_attention(q, k, v)
    assert torch.equal(fill[:b * h * s * d].view(b, h, s, d), out)
    q2, k2, v2 = _qkv(s, b, h, kv, s + 64, d, dtype, cuda)
    longer = flash_kernel.flash_attention(q2, k2, v2)
    assert torch.equal(out, longer[:, :, :s])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_causal_row_ignores_later_positions(cuda, dtype):
    q, k, v = _qkv(1, 1, 9, 3, 200, 64, dtype, cuda)
    out = flash_kernel.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 70:] = 9.0
    v2[:, :, 70:] = -9.0
    assert torch.equal(flash_kernel.flash_attention(q, k2, v2)[:, :, :70],
                       out[:, :, :70])


def test_flash_attention_rejects_bad_input(cuda):
    fa = flash_kernel.flash_attention
    q, k, v = _qkv(0, 1, 4, 2, 16, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        fa(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa(q, k.bfloat16(), v)
    with pytest.raises(ValueError):  # head dim 48
        fa(*_qkv(0, 1, 4, 2, 16, 48, torch.float32, cuda))
    with pytest.raises(ValueError):  # (q.k, v) = (128, 64): no such pair
        fa(q.new_zeros(1, 4, 16, 128), k.new_zeros(1, 2, 16, 128), v)
    with pytest.raises(ValueError):  # 4 query heads on 3 KV heads
        fa(*_qkv(0, 1, 4, 3, 16, 64, torch.float32, cuda))
    with pytest.raises(ValueError):  # k and v of other lengths than q
        fa(q, k[:, :, :8].contiguous(), v[:, :, :8].contiguous())
    with pytest.raises(ValueError):  # 3-d
        fa(q[0], k[0], v[0])
    with pytest.raises(ValueError):  # not contiguous
        fa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError):  # one tensor on the CPU
        fa(q, k.cpu(), v)


#: the backward kernel, fed the forward kernel's o and lse, against the
#: plain gradient from the plain o and lse: each element over the largest
#: |gradient| of its row (over D), that scale at least BWD_FLOOR of the
#: largest |gradient| of the call (dq's causal row 0, and dq and dk at
#: S = 1, are 0 up to rounding).  bf16 computes in f32 from the same bf16
#: inputs and rounds each gradient once, as the plain version does, so two
#: results differ by one bf16 ulp of the row's largest (2^-7) plus f32
#: noise; f32 sums in another order (the smoke's backward phase prints
#: its readings at the training shape).
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
BWD_FLOOR = 1e-2
#: the row logsumexp against the plain one: about ten f32 ulps at the
#: |lse| ~ 10 of these shapes
LSE_ATOL = 1e-5


def _bwd_case(cuda, seed, b, g, kv, s, d, dtype, causal):
    q, k, v = _qkv(seed, b, g * kv, kv, s, d, dtype, cuda)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
    rng = np.random.default_rng(seed + 1)
    dout = torch.from_numpy(rng.standard_normal(tuple(q.shape),
                                                dtype=np.float32))
    return q, k, v, o, lse, dout.to(device=cuda, dtype=dtype)


def _row_scaled_err(got, want, floor):
    """The largest |got - want|, each element over its row's largest
    |want| (over D), that scale taken at least ``floor``."""
    w = want.float()
    row = w.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
    return float(((got.float() - w).abs() / row).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s,g", [(s, g) for g in (1, 3) for s in (
    1, 63, 64, 257, 1500, 2048)] + [(s, g) for g in (7, 8)
                                    for s in (1, 63, 64, 257)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_matches_plain_version(cuda, dtype, d, g, s,
                                                   causal):
    # g = 7 and 8 are yi-34b's and qwen2-72b's query groups, whose dk and
    # dv the kernel sums over the g query heads
    _check_bwd_against_plain(cuda, s + d + g, 1, g, 2, s, d, dtype, causal)


def test_flash_attention_bwd_at_the_training_layout(cuda):
    # the main path's GQA layout: smollm-135m's 9 query heads on 3 KV
    # heads, head dim 64, S = 2048, bf16, causal (B cut to 2)
    _check_bwd_against_plain(cuda, 21, 2, 3, 3, 2048, 64, torch.bfloat16,
                             True)


def _check_bwd_chain(q, k, v, dout, causal):
    """The main path's chain (the forward kernel's o and lse into the
    backward kernel, one launch) against the fully plain chain: o within
    FLASH_TOL, lse within LSE_ATOL, each gradient per row within
    BWD_TOL."""
    dtype = q.dtype
    o, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
    before = flash_kernel.BWD_LAUNCHES.count
    got = flash_kernel.flash_attention_bwd(q, k, v, o, dout, lse,
                                           causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.BWD_LAUNCHES.count == before + 1
    o_ref = flash_kernel.attention_ref(q, k, v, causal=causal)
    lse_ref = flash_kernel.attention_lse_ref(q, k, causal=causal)
    torch.testing.assert_close(o.float(), o_ref.float(),
                               atol=FLASH_TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
    want = flash_kernel.attention_bwd_ref(q, k, v, o_ref, dout, lse_ref,
                                          causal=causal)
    floor = BWD_FLOOR * max(float(w.float().abs().max()) for w in want)
    for name, a, w, x in zip("qkv", got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape, name
        err = _row_scaled_err(a, w, floor)
        assert err <= BWD_TOL[dtype], (
            f"d{name}: {err} of its row's largest > {BWD_TOL[dtype]}")


def _check_bwd_against_plain(cuda, seed, b, g, kv, s, d, dtype, causal):
    q, k, v, _, _, dout = _bwd_case(cuda, seed, b, g, kv, s, d, dtype,
                                    causal)
    _check_bwd_chain(q, k, v, dout, causal)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g,s", [(1, 1), (3, 63), (3, 257), (1, 1500)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_bf16_matches_its_design(cuda, d, g, s, causal):
    """The bf16 kernel against the plain emulation of its own rounding (P
    and dS split into bf16 hi + lo before f32 second products, from the
    kernel's o and lse): both round each gradient once from nearly the same
    f32 value, so they are closer than the limit against the fully plain
    chain."""
    q, k, v, o, lse, dout = _bwd_case(cuda, s + d + 7 * g, 2, g, 2, s, d,
                                      torch.bfloat16, causal)
    got = flash_kernel.flash_attention_bwd(q, k, v, o, dout, lse,
                                           causal=causal)
    want = attention_bwd_bf16_mma_ref(q, k, v, o, dout, lse, causal=causal,
                                      split=True)
    torch.cuda.synchronize()
    floor = BWD_FLOOR * max(float(w.float().abs().max()) for w in want)
    for name, a, w in zip("qkv", got, want):
        err = _row_scaled_err(a, w, floor)
        assert err <= BWD_TOL[torch.bfloat16], (
            f"d{name}: {err} of its row's largest > "
            f"{BWD_TOL[torch.bfloat16]}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_bwd_rejects_misaligned_dout(cuda, dtype):
    q, k, v, o, lse, dout = _bwd_case(cuda, 3, 1, 3, 1, 40, 64, dtype, True)
    flat = torch.empty(dout.numel() + 1, dtype=dtype, device=cuda)
    shifted = flat[1:].view_as(dout)  # contiguous, 2 or 4 bytes off
    shifted.copy_(dout)
    before = flash_kernel.BWD_LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_kernel.flash_attention_bwd(q, k, v, o, shifted, lse)
    assert flash_kernel.BWD_LAUNCHES.count == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 63, 257, 1500, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_matches_plain_version(cuda, dtype, s, causal):
    # the f32 kernel sums in natural-log space; the bf16 one in log2 space
    # over 64-key tiles (32 of them at S = 2048, a ragged last one at
    # 1500) and converts, both from f32 scores of the same inputs
    q, k, v = _qkv(s, 2, 6, 2, s, 64, dtype, cuda)
    _, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
    want = flash_kernel.attention_lse_ref(q, k, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (2, 6, s)
    torch.testing.assert_close(lse, want, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [17, 512])
def test_flash_attention_output_same_bits_with_lse(cuda, dtype, s):
    q, k, v = _qkv(s, 2, 9, 3, s, 64, dtype, cuda)
    for causal in (True, False):
        plain = flash_kernel.flash_attention(q, k, v, causal=causal)
        with_lse, _ = flash_kernel.flash_attention(q, k, v, causal=causal,
                                                   return_lse=True)
        assert torch.equal(plain, with_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_bwd_same_bits_twice(cuda, dtype):
    q, k, v, o, lse, dout = _bwd_case(cuda, 5, 2, 3, 3, 300, 64, dtype,
                                      True)
    first = flash_kernel.flash_attention_bwd(q, k, v, o, dout, lse)
    second = flash_kernel.flash_attention_bwd(q, k, v, o, dout, lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_fn_gradients_through_the_kernels(cuda):
    # autograd through FlashAttentionFn on the card: one forward with lse
    # and one backward launch, gradients equal to the plain backward's
    q, k, v = (x.requires_grad_() for x in
               _qkv(3, 2, 9, 3, 130, 64, torch.float32, cuda))
    f0, b0 = flash_kernel.LAUNCHES.count, flash_kernel.BWD_LAUNCHES.count
    out = flash_kernel.flash_attention_op(q, k, v, causal=True)
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count - f0 == 1
    assert flash_kernel.BWD_LAUNCHES.count - b0 == 1
    lse = flash_kernel.attention_lse_ref(q.detach(), k.detach())
    want = flash_kernel.attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                          out.detach(), dout, lse)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


def _loss_and_grads(model, cfg, batch):
    params = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss, _ = loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        model.requires_grad_(False)
    return loss.detach(), dict(zip(params, grads))


def test_f32_train_step_on_the_card_equals_the_cpu(cuda):
    """One f32 step at 2 layers, full width, B=2, S=256 from the same
    weights: the loss within rtol 1e-5, every gradient within 1e-4 of its
    leaf's largest (cuBLAS and the kernels sum in other orders), and the
    params after the AdamW update from the same gradients within 1e-6 of
    their leaf's largest.  Parity of the params end to end is not held:
    Adam's first step divides g by |g|, so a near-zero gradient's sign
    moves a weight by 2 lr."""
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    cpu = init_model(cfg, 0, device="cpu")
    card = init_model(cfg, 0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 257)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    f0, b0 = flash_kernel.LAUNCHES.count, flash_kernel.BWD_LAUNCHES.count
    loss_d, g_d = _loss_and_grads(card, cfg,
                                  {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    # remat: each layer's forward runs twice, its backward once
    assert flash_kernel.LAUNCHES.count - f0 == 4
    assert flash_kernel.BWD_LAUNCHES.count - b0 == 2
    loss_h, g_h = _loss_and_grads(cpu, cfg, batch)
    np.testing.assert_allclose(float(loss_d), float(loss_h), rtol=1e-5)
    for name, gh in g_h.items():
        torch.testing.assert_close(g_d[name].cpu(), gh, rtol=0,
                                   atol=1e-4 * float(gh.abs().max()),
                                   msg=lambda m: f"{name}: {m}")
    p_d, p_h = dict(card.named_parameters()), dict(cpu.named_parameters())
    opt_cfg = AdamWConfig(lr=1e-3)
    adamw_update(g_d, init_opt_state(p_d), p_d, opt_cfg)
    adamw_update({n: g.cpu() for n, g in g_d.items()}, init_opt_state(p_h),
                 p_h, opt_cfg)
    for name, ph in p_h.items():
        torch.testing.assert_close(p_d[name].cpu(), ph, rtol=0,
                                   atol=1e-6 * float(ph.abs().max()),
                                   msg=lambda m: f"{name}: {m}")


def test_bf16_train_steps_on_the_card(cuda):
    # bf16 params with an f32 master, through both kernels: finite losses,
    # one backward launch per layer and step, the model updated in place
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=3,
                              param_dtype="bfloat16")
    model = init_model(cfg, 0, device=cuda)
    opt = init_opt_state(dict(model.named_parameters()))
    assert "master" in opt
    before = model.embed.table.detach().clone()
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    rng = np.random.default_rng(1)
    b0 = flash_kernel.BWD_LAUNCHES.count
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, (2, 130), dtype=np.int32)
        model, opt, m = step(model, opt, {"tokens": toks[:, :-1],
                                          "targets": toks[:, 1:]})
        assert np.isfinite(float(m["loss"]))
    assert flash_kernel.BWD_LAUNCHES.count - b0 == 3 * cfg.n_layers
    assert int(opt["step"]) == 3
    assert not torch.equal(model.embed.table, before)
    assert torch.equal(model.embed.table,
                       opt["master"]["embed.table"].bfloat16())


# ------------------------------------------- training of the other families
#: the non-dense families, and the encoder-decoder again over a ragged
#: frame count (its cross-attention 128 queries over 37 keys)
FAMILY_CASES = [f for f in families.FAMILIES if f != "dense"] + [
    "encdec-ragged"]


def _family_case(family, dtype):
    """``reduce_config`` of the family's architecture (2 layers; the
    hybrid's 4, two shared-block sites) at the kernels' head widths, and
    its frame count."""
    from repro_torch.configs.base import reduce_config

    arch = families.FAMILIES[family.replace("-ragged", "")]
    cfg = families.kernel_widths(reduce_config(get_config(arch)), dtype)
    return cfg, 37 if family.endswith("-ragged") else None


def _family_batch(cfg, frames, seed, device):
    """B=2, S=128 positions of the family's batch on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in families.batch(
        cfg, 2, 128, np.random.default_rng(seed), frames).items()}


@pytest.mark.parametrize("family", FAMILY_CASES)
def test_f32_family_train_step_on_the_card_equals_the_cpu(cuda, family):
    """One f32 step of each non-dense family, B=2, S=128, from the same
    weights: the loss within rtol 1e-5, every gradient within 1e-4 of its
    leaf's largest, the params after the AdamW update from the same
    gradients within 1e-6 of their leaf's largest, and one backward launch
    per attention site (none for falcon-mamba-7b)."""
    cfg, frames = _family_case(family, "float32")
    cpu = init_model(cfg, 0, device="cpu")
    card = init_model(cfg, 0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = _family_batch(cfg, frames, 3, "cpu")
    b0 = flash_kernel.BWD_LAUNCHES.count
    loss_d, g_d = _loss_and_grads(card, cfg,
                                  {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert flash_kernel.BWD_LAUNCHES.count - b0 == families.attention_sites(
        cfg)
    loss_h, g_h = _loss_and_grads(cpu, cfg, batch)
    np.testing.assert_allclose(float(loss_d), float(loss_h), rtol=1e-5)
    for name, gh in g_h.items():
        torch.testing.assert_close(g_d[name].cpu(), gh, rtol=0,
                                   atol=1e-4 * float(gh.abs().max()),
                                   msg=lambda m: f"{name}: {m}")
    p_d, p_h = dict(card.named_parameters()), dict(cpu.named_parameters())
    opt_cfg = AdamWConfig(lr=1e-3)
    adamw_update(g_d, init_opt_state(p_d), p_d, opt_cfg)
    adamw_update({n: g.cpu() for n, g in g_d.items()}, init_opt_state(p_h),
                 p_h, opt_cfg)
    for name, ph in p_h.items():
        torch.testing.assert_close(p_d[name].cpu(), ph, rtol=0,
                                   atol=1e-6 * float(ph.abs().max()),
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("family", FAMILY_CASES)
def test_bf16_family_train_steps_on_the_card(cuda, family):
    """Three bf16 steps with an f32 master and remat, B=2, S=128: finite
    losses, one backward launch per attention site and step, the params
    moved and equal to the master rounded to bf16."""
    cfg, frames = _family_case(family, "bfloat16")
    model = init_model(cfg, 0, device=cuda)
    opt = init_opt_state(dict(model.named_parameters()))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    b0 = flash_kernel.BWD_LAUNCHES.count
    for i in range(3):
        model, opt, m = step(model, opt, _family_batch(cfg, frames, i, cuda))
        assert np.isfinite(float(m["loss"])), i
    assert (flash_kernel.BWD_LAUNCHES.count - b0
            == 3 * families.attention_sites(cfg))
    assert int(opt["step"]) == 3
    for name, p in model.named_parameters():
        assert torch.equal(p, opt["master"][name].bfloat16()), name
    assert not torch.equal(model.embed.table, before["embed.table"])


def _full_width_smollm(cuda, **kw):
    cfg = make_serve_config(get_config("smollm-135m"), model_axis=1)
    cfg = dataclasses.replace(cfg, **kw)
    return cfg, init_model(cfg, 0, device=cuda)


def test_full_width_prefill_launches_flash_attention_per_layer(cuda):
    cfg, model = _full_width_smollm(cuda)
    assert cfg.n_layers == 30 and model.embed.table.dtype == torch.bfloat16
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 100))
    prefill = make_prefill_step(cfg, 128, device=str(cuda))
    before = flash_kernel.LAUNCHES.count
    logits, caches = prefill(model, {"tokens": prompt})
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count - before == 30
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    plain = lambda q, k, v, causal=True: flash_kernel.attention_ref(  # noqa
        q, k, v, causal=causal)
    with mock.patch.object(attention_mod, "flash_attention_op", plain):
        want, _ = prefill(model, {"tokens": prompt})
    assert flash_kernel.LAUNCHES.count - before == 30
    torch.testing.assert_close(logits, want, atol=5e-2, rtol=0)


def test_full_width_olmo_prefill_launches_flash_attention_per_layer(cuda):
    """olmo-1b whole (16 layers, 16 heads of 128 on 16, the non-parametric
    LayerNorm) drawn on the card: a prefill launches the kernel once a
    layer, with finite logits, and each layer's attention output within
    2e-2 (or one bf16 ulp of the plain value) of the plain version on its
    own q, k, v."""
    cfg = make_serve_config(get_config("olmo-1b"), model_axis=1)
    model = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    assert sum(p.numel() for p in model.parameters()) == 1_279_787_008
    assert model.final_norm.scale is None
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (2, 200))
    prefill = make_prefill_step(cfg, 256, device=str(cuda))
    real, over = attention_mod.flash_attention_op, []

    def beside_plain(q, k, v, causal=True):
        got = real(q, k, v, causal=causal)
        want = flash_kernel.attention_ref(q, k, v, causal=causal).float()
        _, e = torch.frexp(want)
        ulp = torch.ldexp(torch.full_like(want, 2.0 ** -7), e - 1)
        over.append(float(((got.float() - want).abs()
                           / ulp.clamp_min(FLASH_TOL[got.dtype])).max()))
        return got

    before = flash_kernel.LAUNCHES.count
    with mock.patch.object(attention_mod, "flash_attention_op",
                           beside_plain):
        logits, _ = prefill(model, {"tokens": prompt})
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count - before == 16
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert len(over) == 16 and max(over) <= 1.0, over


def test_batcher_on_cuda_prefills_through_the_kernel(cuda):
    cfg, model = _full_width_smollm(cuda, n_layers=2)
    batcher = ContinuousBatcher(cfg, model, slots=2, max_len=64,
                                device=str(cuda))
    assert batcher.caches["layers"]["k"].device.type == "cuda"
    rng = np.random.default_rng(1)
    for n in (5, 17, 9):
        batcher.submit(rng.integers(0, cfg.vocab, n), max_new=4)
    before = flash_kernel.LAUNCHES.count
    stats = batcher.run_until_drained()
    assert stats["requests"] == 3
    assert flash_kernel.LAUNCHES.count - before == 2 * 2  # 2 waves x layers
    assert all(len(r.out_tokens) == 4 for r in batcher.finished)


# ---------------------------------------------------------------- MoE family
def test_flash_attention_at_the_moe_prefill_shape(cuda):
    # qwen3-moe-30b-a3b's prefill: B=8, 32 query heads on 4 KV heads
    # (G = 8), S=512, head_dim 128
    q, k, v = _qkv(128, 8, 32, 4, 512, 128, torch.bfloat16, cuda)
    got = flash_kernel.flash_attention(q, k, v, causal=True)
    want = flash_kernel.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[torch.bfloat16], rtol=0)


def _moe_cfg(**kw):
    """qwen3-moe-30b-a3b's routing (128 experts, top 8, capacity 1.25) at
    a narrow width, f32."""
    cfg = get_config("qwen3-moe-30b-a3b")
    return dataclasses.replace(cfg, d_model=256, n_layers=2, vocab=512,
                               moe=dataclasses.replace(cfg.moe,
                                                       d_expert_ff=64),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)


def test_moe_block_on_the_card_matches_the_cpu(cuda):
    """An f32 MoE block: the same routing (top-k, positions, keep) on the
    card as on the CPU, and the output within 1e-5."""
    cfg = _moe_cfg()
    block = moe_mod.MoE(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 128, cfg.d_model), dtype=np.float32))
    xt = x.reshape(-1, cfg.d_model)
    logits = moe_mod.dense_apply(block.router, xt, torch.float32)
    gates = torch.sort(torch.softmax(logits, -1), -1, descending=True).values
    gap = float((gates[:, 7] - gates[:, 8]).min())
    want = moe_mod.moe_apply(block, x, cfg)
    plan = moe_mod.route(logits, cfg)
    block = block.to(cuda)  # in place: the CPU results are taken
    got = moe_mod.moe_apply(block, x.to(cuda), cfg)
    plan_c = moe_mod.route(moe_mod.dense_apply(block.router, xt.to(cuda),
                                               torch.float32), cfg)
    for key in ("idx", "pos", "keep", "slot"):
        assert torch.equal(plan_c[key].cpu(), plan[key]), (
            f"{key} differs; the smallest 8th-9th gate gap is {gap}")
    assert plan_c["cap"] == plan["cap"] == 40
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


def test_moe_prefill_on_the_card_launches_flash_attention(cuda):
    cfg = make_serve_config(_moe_cfg(head_dim=64, n_heads=8, n_kv_heads=2),
                            1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = init_model(cfg, gen, device=cuda)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (2, 70))
    prefill = make_prefill_step(cfg, 80, device=str(cuda))
    before = flash_kernel.LAUNCHES.count
    logits, caches = prefill(model, {"tokens": prompt})
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count - before == cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    assert caches["layers"]["k"].device.type == "cuda"


def test_init_model_draws_on_the_card_with_a_cuda_generator(cuda):
    """A CUDA generator draws every weight on the card, the same weights
    for the same seed, at the reference's scales (each drawn leaf's std
    within 2 % of its scale)."""
    cfg = make_serve_config(dataclasses.replace(
        get_config("qwen3-moe-30b-a3b"), n_layers=1), 1)
    a = init_model(cfg, torch.Generator(device=cuda).manual_seed(3),
                   device=cuda)
    b = init_model(cfg, torch.Generator(device=cuda).manual_seed(3),
                   device=cuda)
    d, ff = cfg.d_model, cfg.moe.d_expert_ff
    scales = {"embed.table": 0.02, "lm_head.w": d ** -0.5,
              "layers.0.attn.wq.w": d ** -0.5,
              "layers.0.attn.wo.w": (cfg.n_heads * cfg.head_dim) ** -0.5,
              "layers.0.moe.router.w": d ** -0.5,
              "layers.0.moe.w_gate": d ** -0.5,
              "layers.0.moe.w_up": d ** -0.5,
              "layers.0.moe.w_down": ff ** -0.5}
    named = dict(a.named_parameters())
    for name, p in named.items():
        assert p.device.type == "cuda" and p.dtype == torch.bfloat16, name
        assert torch.equal(p, dict(b.named_parameters())[name]), name
    for name, scale in scales.items():
        std = float(named[name].float().std())
        assert abs(std - scale) <= 0.02 * scale, (name, std, scale)
    with pytest.raises(ValueError, match="draws on that device"):
        init_model(cfg, torch.Generator(device=cuda), device="cpu")


# ------------------------------------------------------ MLA: q.k 192, v 128
def _qkv_mla(seed, b, h, kv, s, dtype, device):
    q, k, _ = _qkv(seed, b, h, kv, s, 192, dtype, device)
    v = _qkv(seed + 1, b, kv, kv, s, 128, dtype, device)[2]
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("s", [1, 15, 17, 63, 65, 100, 257, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_192_128_matches_plain_version(cuda, dtype, g, s,
                                                          causal):
    """MLA's widths: q and k of 192 dims, v and o of 128, scaled by
    1/sqrt(192); G query heads on a KV head, S around the tiles."""
    q, k, v = _qkv_mla(s + g, 2, 2 * g, 2, s, dtype, cuda)
    before = flash_kernel.LAUNCHES.count
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count == before + 1
    assert got.dtype == dtype and got.shape == (2, 2 * g, s, 128)
    want = flash_kernel.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_at_the_mla_prefill_shape(cuda, dtype):
    """deepseek-v2-lite-16b's B=8, S=512 prefill: 16 heads on 16 (G = 1),
    with the row logsumexp against the plain one."""
    q, k, v = _qkv_mla(0, 8, 16, 16, 512, dtype, cuda)
    got, lse = flash_kernel.flash_attention(q, k, v, causal=True,
                                            return_lse=True)
    want = flash_kernel.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, flash_kernel.attention_lse_ref(q, k),
                               atol=LSE_ATOL, rtol=0)
    assert torch.equal(flash_kernel.flash_attention(q, k, v), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_attention_old_pairs_same_bits_twice(cuda, dtype, d):
    """The (D, D) pairs after the kernel took a v width of its own: two
    calls give the same bits, causal and not, at a ragged S and G = 3
    (``scripts/torch_kernel_probe.py --baseline`` holds them bit for bit
    against the kernel before the change)."""
    q, k, v = _qkv(d, 2, 6, 2, 200, d, dtype, cuda)
    for causal in (True, False):
        a = flash_kernel.flash_attention(q, k, v, causal=causal)
        b = flash_kernel.flash_attention(q, k, v, causal=causal)
        assert torch.equal(a, b)
        torch.testing.assert_close(
            a.float(), flash_kernel.attention_ref(q, k, v,
                                                  causal=causal).float(),
            atol=FLASH_TOL[dtype], rtol=0)


def _dout(seed, q, dv):
    rng = np.random.default_rng(seed)
    shape = (*q.shape[:3], dv)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device=q.device, dtype=q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("s", [1, 17, 63, 65, 257, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_at_192_128_matches_plain_version(cuda, dtype, g,
                                                              s, causal):
    """MLA's widths in the backward: dq and dk of 192 dims, dv of 128, G
    query heads on a KV head, S around the tiles (bf16: the dv and the dk
    pass of the tensor-core kernel, dq over two 32-key halves a tile)."""
    q, k, v = _qkv_mla(s + 5 * g, 2, 2 * g, 2, s, dtype, cuda)
    _check_bwd_chain(q, k, v, _dout(s + g, q, 128), causal)


def test_flash_attention_bwd_at_the_mla_prefill_shape(cuda):
    """deepseek-v2-lite-16b's B=8, S=512 training attention, bf16
    causal."""
    q, k, v = _qkv_mla(9, 8, 16, 16, 512, torch.bfloat16, cuda)
    _check_bwd_chain(q, k, v, _dout(9, q, 128), True)


# ------------------------------------- cross-attention: keys of length Skv
def _qkv_cross(seed, b, h, kv, sq, skv, dqk, dv, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((b, h, sq, dqk), (b, kv, skv, dqk),
                          (b, kv, skv, dv))]


#: (S, Skv): the encoder-decoder's cross-attention (512 over 128), keys
#: longer than queries, a ragged last key tile, one key, one query
CROSS_LENGTHS = [(512, 128), (256, 100), (100, 37), (64, 256), (128, 512),
                 (65, 63), (17, 1), (1, 77)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dqk,dv", flash_kernel.flash.PAIRS)
@pytest.mark.parametrize("sq,skv", CROSS_LENGTHS)
@pytest.mark.parametrize("g", [1, 3])
def test_flash_attention_cross_lengths_match_plain_version(cuda, dtype, dqk,
                                                           dv, sq, skv, g):
    """Not causal, q of length S over k and v of length Skv, at every
    (q.k, v) pair and G query heads a KV head: the kernel within the
    reference's tolerance of the plain version, o [B, H, S, Dv] and the
    row logsumexp [B, H, S]."""
    q, k, v = _qkv_cross(sq * 7 + skv + dqk, 2, 2 * g, 2, sq, skv, dqk, dv,
                         dtype, cuda)
    before = flash_kernel.LAUNCHES.count
    got, lse = flash_kernel.flash_attention(q, k, v, causal=False,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count == before + 1
    assert got.dtype == dtype and got.shape == (2, 2 * g, sq, dv)
    want = flash_kernel.attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=0)
    torch.testing.assert_close(
        lse, flash_kernel.attention_lse_ref(q, k, causal=False),
        atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", [(512, 128), (100, 37), (64, 256)])
def test_flash_attention_cross_rows_are_independent(cuda, dtype, sq, skv):
    """Each query row over Skv keys is computed alone: the first n rows of
    a call equal, bit for bit, a call on those n rows (n ragged); and the
    raw entry given Skv reads no key row past it (one KV head, whose
    buffer goes on with poisoned rows)."""
    q, k, v = _qkv_cross(sq + skv, 1, 8, 1, sq, skv + 64, 64, 64, dtype,
                         cuda)
    kk, vv = k[:, :, :skv].contiguous(), v[:, :, :skv].contiguous()
    full = flash_kernel.flash_attention(q, kk, vv, causal=False)
    for n in (1, 17, sq - 3):
        part = flash_kernel.flash_attention(q[:, :, :n].contiguous(), kk, vv,
                                            causal=False)
        assert torch.equal(part, full[:, :, :n])
    k[:, :, skv:], v[:, :, skv:] = 1e4, float("nan")
    out = torch.empty_like(full)
    lib = flash_kernel.LIBRARY.load()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 1,
        8, 1, sq, skv, 64, 64, flash_kernel.flash.DTYPES[dtype], 0,
        64 ** -0.5, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, full)


def test_flash_attention_causal_with_two_lengths_raises(cuda):
    """Causal attention with Skv != S is refused by the wrapper (before a
    launch), by the raw entry, and by the plain version."""
    q, k, v = _qkv_cross(3, 1, 4, 2, 64, 32, 64, 64, torch.bfloat16, cuda)
    before = flash_kernel.LAUNCHES.count
    with pytest.raises(ValueError, match="causal"):
        flash_kernel.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        flash_kernel.flash_attention_op(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        flash_kernel.attention_ref(q, k, v, causal=True)
    assert flash_kernel.LAUNCHES.count == before
    out = torch.empty_like(q)
    lib = flash_kernel.LIBRARY.load()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 1,
        4, 2, 64, 32, 64, 64, flash_kernel.flash.DTYPES[q.dtype], 1,
        64 ** -0.5, torch.cuda.current_stream().cuda_stream)
    assert err != 0


#: (S, Skv) of the backward over keys of another length: seamless'
#: cross-attention (512 over 128), the ragged 96 over 40 and 100 over 37,
#: keys longer than queries, one key, one query
BWD_CROSS_LENGTHS = [(512, 128), (96, 40), (100, 37), (64, 256), (65, 63),
                     (17, 1), (1, 77)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dqk,dv", flash_kernel.flash.PAIRS)
@pytest.mark.parametrize("sq,skv", BWD_CROSS_LENGTHS)
@pytest.mark.parametrize("g", [1, 3])
def test_flash_attention_bwd_cross_lengths_match_plain_version(
        cuda, dtype, dqk, dv, sq, skv, g):
    """Not causal, S queries over Skv keys, at every (q.k, v) pair: dq
    [B, H, S, Dqk], dk [B, KV, Skv, Dqk] and dv [B, KV, Skv, Dv] per row
    within BWD_TOL of the plain chain (the dk/dv grid over Skv's key
    tiles, the dq grid over S's query tiles)."""
    q, k, v = _qkv_cross(sq * 3 + skv + dqk + g, 2, 2 * g, 2, sq, skv, dqk,
                         dv, dtype, cuda)
    _check_bwd_chain(q, k, v, _dout(sq + skv, q, dv), False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_bwd_at_the_cross_attention_shape(cuda, dtype):
    """seamless-m4t-medium's training cross-attention: B=8, 16 heads of
    64, 512 decoder queries over 128 encoder frames."""
    q, k, v = _qkv_cross(8, 8, 16, 16, 512, 128, 64, 64, dtype, cuda)
    _check_bwd_chain(q, k, v, _dout(8, q, 64), False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["mla", "cross", "mla-cross"])
def test_flash_attention_bwd_new_cases_same_bits_twice(cuda, dtype, case):
    sq, skv = (257, 257) if case == "mla" else (96, 40)
    dqk, dv = (64, 64) if case == "cross" else (192, 128)
    causal = case == "mla"
    q, k, v = _qkv_cross(31, 2, 6, 2, sq, skv, dqk, dv, dtype, cuda)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
    dout = _dout(32, q, dv)
    first = flash_kernel.flash_attention_bwd(q, k, v, o, dout, lse,
                                             causal=causal)
    second = flash_kernel.flash_attention_bwd(q, k, v, o, dout, lse,
                                              causal=causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["mla", "cross"])
def test_flash_attention_fn_gradient_at_the_new_cases(cuda, dtype, case):
    """A gradient through ``FlashAttentionFn`` on the card at MLA's widths
    (causal) and over keys of another length (not causal): one forward
    launch with the lse, one backward launch, and no plain fallback; the
    gradients per row within BWD_TOL of the plain backward's."""
    if case == "mla":
        q, k, v = _qkv_mla(12, 2, 6, 2, 130, dtype, cuda)
    else:
        q, k, v = _qkv_cross(13, 2, 6, 2, 96, 40, 64, 64, dtype, cuda)
    causal = case == "mla"
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    f0, b0 = flash_kernel.LAUNCHES.count, flash_kernel.BWD_LAUNCHES.count
    with mock.patch.object(flash_kernel.ops, "attention_bwd_ref",
                           side_effect=AssertionError("plain backward")):
        out = flash_kernel.flash_attention_op(q, k, v, causal=causal)
        dout = _dout(14, q, v.shape[3])
        got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count - f0 == 1
    assert flash_kernel.BWD_LAUNCHES.count - b0 == 1
    qd, kd, vd = (x.detach() for x in (q, k, v))
    want = flash_kernel.attention_bwd_ref(
        qd, kd, vd, flash_kernel.attention_ref(qd, kd, vd, causal=causal),
        dout, flash_kernel.attention_lse_ref(qd, kd, causal=causal),
        causal=causal)
    floor = BWD_FLOOR * max(float(w.float().abs().max()) for w in want)
    for a, w in zip(got, want):
        assert _row_scaled_err(a, w, floor) <= BWD_TOL[dtype]


def test_flash_attention_bwd_causal_with_two_lengths_raises(cuda):
    """Causal with Skv != S is refused by the backward's wrapper (before a
    launch) and by its raw entry, as the forward refuses it."""
    q, k, v = _qkv_cross(3, 1, 4, 2, 64, 32, 64, 64, torch.bfloat16, cuda)
    o, lse = flash_kernel.flash_attention(q, k, v, causal=False,
                                          return_lse=True)
    before = flash_kernel.BWD_LAUNCHES.count
    with pytest.raises(ValueError, match="causal"):
        flash_kernel.flash_attention_bwd(q, k, v, o, torch.ones_like(o), lse,
                                         causal=True)
    assert flash_kernel.BWD_LAUNCHES.count == before
    grads = [torch.empty_like(x) for x in (q, k, v)]
    delta = torch.empty_like(lse)
    lib = flash_kernel.BWD_LIBRARY.load()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(g.data_ptr() for g in grads), 1, 4, 2, 64, 32, 64, 64,
        flash_kernel.flash.DTYPES[q.dtype], 1, 64 ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def _mla_cfg(**kw):
    """Reduced deepseek-v2-lite-16b in f32 with MLA at its published
    widths (q.k 128 + 64, v 128, rank 512), so the prefill runs the
    kernel at 192 / 128."""
    from repro_torch.configs.base import reduce_config

    cfg = reduce_config(get_config("deepseek-v2-lite-16b"))
    mla = dataclasses.replace(cfg.mla, kv_lora_rank=512, qk_nope_head_dim=128,
                              qk_rope_head_dim=64, v_head_dim=128)
    return dataclasses.replace(cfg, mla=mla, d_model=256,
                               param_dtype="float32",
                               compute_dtype="float32", **kw)


@pytest.mark.parametrize("arch,quant", [("deepseek-v2-lite-16b", False),
                                        ("deepseek-v2-lite-16b", True),
                                        ("smollm-135m", True)],
                         ids=["mla", "mla-int8", "gqa-int8"])
def test_int8_and_mla_decode_on_the_card_match_the_cpu(cuda, arch, quant):
    """An f32 model on the card against the CPU on the same weights: a
    prefill of 64 tokens (the kernel once per layer) and three decode
    steps, logits within 1e-4 on the float cache; every float cache entry
    within 1e-4.  On the int8 cache a code differs by one where x / scale
    lies within the two devices' f32 error of .5 (at most 1e-3 of the
    codes), which moves that latent value by a whole quantum (1/127 of
    its row's largest): the logits are held to 1e-3 there, the smoke's
    int8 gate."""
    from repro_torch.configs.base import reduce_config
    from repro_torch.models import decode_step, init_cache

    if arch == "smollm-135m":
        cfg = dataclasses.replace(reduce_config(get_config(arch)),
                                  d_model=256, head_dim=64,
                                  param_dtype="float32",
                                  compute_dtype="float32")
    else:
        cfg = _mla_cfg()
    cfg = dataclasses.replace(cfg, kv_cache_quant=quant)
    model = init_model(cfg, torch.Generator(device=cuda).manual_seed(3),
                       device=cuda)
    cpu = _on_cpu(model, cfg)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 70)))
    caches = {d: init_cache(cfg, 2, 80, device=d) for d in ("cpu", cuda)}
    before = flash_kernel.LAUNCHES.count
    for step in range(4):
        idx = 0 if step == 0 else 63 + step
        t = tokens[:, :64] if step == 0 else tokens[:, idx:idx + 1]
        want, _ = decode_step(cpu, cfg, {"tokens": t}, caches["cpu"],
                              cache_index=idx)
        got, _ = decode_step(model, cfg, {"tokens": t.to(cuda)},
                             caches[cuda], cache_index=idx)
        torch.testing.assert_close(got.cpu(), want,
                                   atol=1e-3 if quant else 1e-4, rtol=0)
    for key, stack in caches["cpu"].items():
        for n, c in stack.items():
            g = caches[cuda][key][n].cpu()
            if c.dtype == torch.int8:
                assert (g.int() - c.int()).abs().max() <= 1
                assert float((g != c).float().mean()) <= 1e-3
            else:
                torch.testing.assert_close(g, c, atol=1e-4, rtol=0)
    assert flash_kernel.LAUNCHES.count - before == cfg.n_layers


# ------------------------------------------------- SSM and hybrid families
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 256, 128),
                                   (8, 32, 32, 512, 128)])
def test_flash_attention_at_the_hybrid_shapes(cuda, shape, dtype):
    """MHA (G = 1) at D = 128: zamba2-1.2b's shared block runs at twice
    d_model, 32 heads of 128 on 32 KV heads; (8, 32, 32, 512, 128) is its
    B=8, S=512 prefill."""
    q, k, v = _qkv(sum(shape), *shape, dtype, cuda)
    before = flash_kernel.LAUNCHES.count
    got = flash_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count == before + 1
    want = flash_kernel.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=0)


def _ssm_cfg(arch, **kw):
    """The reduced config of ``arch`` in f32 (zamba2: 5 layers, two
    shared-block sites and a trailing layer)."""
    from repro_torch.configs.base import reduce_config

    cfg = reduce_config(get_config(arch))
    if cfg.family == "hybrid":
        kw = {"n_layers": 5, **kw}
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def _on_cpu(model, cfg):
    from repro_torch.models import Model

    cpu = Model(cfg, device="meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_ssm_model_on_the_card_matches_the_cpu(cuda, arch):
    """An f32 SSM or hybrid model at a narrow width: the prefill logits,
    every cache entry after it and three decode steps on the card within
    1e-4 of the CPU's on the same weights; the hybrid's prefill launches
    the kernel once per shared-block site."""
    from repro_torch.models import decode_step, init_cache

    cfg = _ssm_cfg(arch, d_model=256)
    model = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    cpu = _on_cpu(model, cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 70)))
    caches = {d: init_cache(cfg, 2, 80, device=d) for d in ("cpu", cuda)}
    before = flash_kernel.LAUNCHES.count
    for step in range(4):
        idx = 0 if step == 0 else 63 + step
        t = tokens[:, :64] if step == 0 else tokens[:, idx:idx + 1]
        want, _ = decode_step(cpu, cfg, {"tokens": t}, caches["cpu"],
                              cache_index=idx)
        got, _ = decode_step(model, cfg, {"tokens": t.to(cuda)},
                             caches[cuda], cache_index=idx)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
        for key, stack in caches["cpu"].items():
            for n, c in stack.items():
                torch.testing.assert_close(caches[cuda][key][n].cpu(), c,
                                           atol=1e-4, rtol=0)
    sites = cfg.n_layers // cfg.hybrid.shared_attn_every if cfg.hybrid \
        else 0
    assert flash_kernel.LAUNCHES.count - before == sites


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_ssm_prefill_then_decode_equals_the_longer_prefill_on_the_card(
        cuda, arch):
    """The carried state on the card: a prefill of 64 tokens (four chunks
    of 16) and a decode step agree with a prefill of 65 (one chunk)."""
    from repro_torch.models import decode_step, init_cache

    cfg = _ssm_cfg(arch, d_model=256)
    model = init_model(cfg, torch.Generator(device=cuda).manual_seed(1),
                       device=cuda)
    t = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 65))).to(cuda)
    caches = init_cache(cfg, 2, 72, device=cuda)
    decode_step(model, cfg, {"tokens": t[:, :64]}, caches, cache_index=0)
    got, _ = decode_step(model, cfg, {"tokens": t[:, 64:]}, caches,
                         cache_index=64)
    want, _ = decode_step(model, cfg, {"tokens": t},
                          init_cache(cfg, 2, 72, device=cuda), cache_index=0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_ssm_batcher_on_the_card_resets_the_state(cuda):
    """bf16 zamba2 at a narrow width: a request repeated in the second
    wave gets its first-wave tokens; each wave launches the kernel once
    per site."""
    cfg = make_serve_config(_ssm_cfg("zamba2-1.2b", d_model=256), 1)
    model = init_model(cfg, torch.Generator(device=cuda).manual_seed(2),
                       device=cuda)
    batcher = ContinuousBatcher(cfg, model, slots=2, max_len=64,
                                device=str(cuda))
    rng = np.random.default_rng(2)
    first = rng.integers(0, cfg.vocab, 20)
    for prompt in (first, rng.integers(0, cfg.vocab, 9), first,
                   rng.integers(0, cfg.vocab, 13)):
        batcher.submit(prompt, max_new=6)
    before = flash_kernel.LAUNCHES.count
    stats = batcher.run_until_drained()
    assert stats["requests"] == 4
    assert flash_kernel.LAUNCHES.count - before == 2 * 2  # waves x sites
    tokens = {r.rid: r.out_tokens for r in batcher.finished}
    assert tokens[2] == tokens[0]


# ----------------------------------------------------------------- sad_search
SAD_RTOL = 1e-5


def _sad_inputs(seed, n, b, r, integer=False):
    rng = np.random.default_rng(seed)
    w = b + 2 * r
    if integer:
        return (rng.integers(0, 4, (n, b, b)).astype(np.float32),
                rng.integers(0, 4, (n, w, w)).astype(np.float32))
    return ((rng.standard_normal((n, b, b)) * 25).astype(np.float32),
            (rng.standard_normal((n, w, w)) * 25).astype(np.float32))


def _sad_at(cur, win, dy, dx):
    """The plain SAD of candidate (dy[n], dx[n]) of every block n."""
    b = cur.shape[-1]
    rows = (dy.long()[:, None] + torch.arange(b, device=cur.device))
    cols = (dx.long()[:, None] + torch.arange(b, device=cur.device))
    cand = win[torch.arange(cur.shape[0], device=cur.device)[:, None, None],
               rows[:, :, None], cols[:, None, :]]
    return (cur - cand).abs().sum(dim=(1, 2))


@pytest.mark.parametrize("n", [1, 7, 64, 500])
@pytest.mark.parametrize("b,r", [(8, 4), (16, 8), (8, 8), (4, 0), (8, 1),
                                 (8, 5), (16, 3), (5, 2)])
def test_sad_search_matches_plain_version(cuda, b, r, n):
    cur, win = (torch.from_numpy(x).to(cuda)
                for x in _sad_inputs(b * 100 + r * 10 + n, n, b, r))
    before = sad_kernel.LAUNCHES.count
    dy, dx, sad = sad_kernel.sad_search(cur, win)
    torch.cuda.synchronize()
    assert sad_kernel.LAUNCHES.count == before + 1
    assert (dy.dtype, dx.dtype, sad.dtype) == (torch.int32, torch.int32,
                                               torch.float32)
    rdy, rdx, rsad = sad_kernel.sad_search_ref(cur, win)
    torch.testing.assert_close(sad, rsad, rtol=SAD_RTOL, atol=0)
    # equal choices except at near-ties, where the kernel's candidate is
    # as good as the plain minimum to within the tolerance
    off = (dy != rdy) | (dx != rdx)
    chosen = _sad_at(cur, win, dy, dx)
    assert bool(((chosen - rsad).abs() <= SAD_RTOL * rsad.abs())[off].all())


def test_sad_search_at_the_1080p_motion_shape(cuda):
    cur, win = (torch.from_numpy(x).to(cuda)
                for x in _sad_inputs(32400, 32400, 8, 8))
    dy, dx, sad = sad_kernel.sad_search_op(cur, win)
    rdy, rdx, rsad = sad_kernel.sad_search_ref(cur, win)
    torch.testing.assert_close(sad, rsad, rtol=SAD_RTOL, atol=0)
    off = (dy != rdy) | (dx != rdx)
    assert int(off.sum()) <= 32  # near-ties only
    chosen = _sad_at(cur, win, dy, dx)
    assert bool(((chosen - rsad).abs() <= SAD_RTOL * rsad.abs())[off].all())


@pytest.mark.parametrize("b,r,n", [(8, 4, 64), (16, 8, 9), (4, 0, 5),
                                   (8, 8, 333), (3, 2, 17)])
def test_sad_search_integer_pixels_exact_with_ties(cuda, b, r, n):
    cur, win = _sad_inputs(n + b, n, b, r, integer=True)
    win[0] = 3.0  # every candidate ties: the first, (0, 0), wins
    cur, win = torch.from_numpy(cur).to(cuda), torch.from_numpy(win).to(cuda)
    got = sad_kernel.sad_search(cur, win)
    want = sad_kernel.sad_search_ref(cur, win)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (int(got[0][0]), int(got[1][0])) == (0, 0)


def test_sad_search_planted_motion_on_a_frame(cuda):
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    cur = np.roll(ref, shift=(3, -2), axis=(0, 1))
    blocks, windows = sad_kernel.frame_motion_blocks(cur, ref, b=16, r=8)
    dy, dx, sad = sad_kernel.sad_search_op(torch.from_numpy(blocks).to(cuda),
                                           torch.from_numpy(windows).to(cuda))
    for i in (5, 6, 9, 10):
        assert (int(dy[i]), int(dx[i]), float(sad[i])) == (5, 10, 0.0)


def test_sad_search_rejects_bad_input(cuda):
    cur, win = (torch.from_numpy(x).to(cuda) for x in _sad_inputs(0, 4, 8, 4))
    before = sad_kernel.LAUNCHES.count
    with pytest.raises(ValueError):  # one tensor on the CPU
        sad_kernel.sad_search(cur, win.cpu())
    with pytest.raises(TypeError):
        sad_kernel.sad_search(cur.double(), win.double())
    with pytest.raises(ValueError):  # not contiguous
        sad_kernel.sad_search(cur.transpose(1, 2), win)
    with pytest.raises(ValueError):  # window narrower than the block
        sad_kernel.sad_search(cur, win[:, :6, :6].contiguous())
    big = torch.zeros((1, 16, 16), device=cuda)
    with pytest.raises(ValueError):  # the tiles exceed shared memory
        sad_kernel.sad_search(big, torch.zeros((1, 116, 116), device=cuda))
    assert sad_kernel.LAUNCHES.count == before
    # the op casts any real dtype to f32 on the card
    dy, dx, sad = sad_kernel.sad_search_op(cur.double(), win.half().float())
    assert sad.dtype == torch.float32


def _sad_in_contract_order(cur, win, chunk=2048):
    """The kernel's contract, one separately rounded elementwise op at a
    time: each candidate sums its row of |cur - cand| in x order from 0,
    then the rows in y order; a NaN or +inf SAD is never taken, the first
    least SAD in row-major (dy, dx) order wins, and (0, 0, +inf) where
    none is taken."""
    n, b, _ = cur.shape
    r2 = win.shape[-1] - b + 1
    outs = []
    for lo in range(0, n, chunk):
        c, w = cur[lo:lo + chunk], win[lo:lo + chunk]
        cand = w.unfold(1, b, 1).unfold(2, b, 1)  # [n, r2, r2, b, b]
        d = (c[:, None, None] - cand).abs()
        tot = torch.zeros(d.shape[:3], device=d.device)
        for y in range(b):
            row = torch.zeros(d.shape[:3], device=d.device)
            for x in range(b):
                row = row + d[:, :, :, y, x]
            tot = tot + row
        tot = tot.reshape(len(c), r2 * r2)
        tot = torch.where(torch.isnan(tot), torch.inf, tot)
        best = torch.argmin(tot, dim=1)  # the first least value
        outs.append(((best // r2).to(torch.int32),
                     (best % r2).to(torch.int32),
                     tot.gather(1, best[:, None])[:, 0]))
    return tuple(torch.cat(x) for x in zip(*outs))


def _assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32),
                                                  w.view(torch.int32))


@pytest.mark.parametrize("n", [1, 7, 33, 500, 32400])
@pytest.mark.parametrize("b,r", [(8, 8), (16, 8)])
def test_sad_search_bit_identical_to_the_contract_order(cuda, b, r, n):
    # float pixels: every SAD rounds, so only the summation order of the
    # contract gives these bits
    cur, win = (torch.from_numpy(x).to(cuda)
                for x in _sad_inputs(n * 3 + b, n, b, r))
    got = sad_kernel.sad_search(cur, win)
    _assert_same_bits(got, _sad_in_contract_order(cur, win))


@pytest.mark.parametrize("b,r", [(8, 8), (16, 8), (5, 2), (8, 1)])
def test_sad_search_nan_and_inf_never_taken(cuda, b, r):
    n, w = 6, b + 2 * r
    cur, win = (torch.from_numpy(x).to(cuda) for x in _sad_inputs(b, n, b, r))
    win[0] = torch.nan  # every candidate NaN: none taken
    win[1] = torch.inf  # every candidate +inf: none taken
    win[2, 0, 0] = torch.nan  # candidate (0, 0) NaN, the rest finite
    win[3, :, w - 1] = torch.inf  # the last column's candidates +inf
    cur[4, 0, 0] = -torch.inf  # every candidate of block 4 +inf ...
    win[4, r, r] = -torch.inf  # ... but (r, r): -inf - -inf is NaN
    win[5, w - 1, :] = torch.nan  # the last dy's candidates NaN
    got = sad_kernel.sad_search(cur, win)
    want = _sad_in_contract_order(cur, win)
    _assert_same_bits(got, want)
    for i in (0, 1, 4):
        assert (int(got[0][i]), int(got[1][i])) == (0, 0)
        assert float(got[2][i]) == float("inf")
    assert bool(torch.isfinite(got[2][[2, 3, 5]]).all())
    assert (int(got[0][2]), int(got[1][2])) != (0, 0)


@pytest.mark.parametrize("b,r", [(8, 8), (16, 8), (5, 2)])
def test_sad_search_misaligned_views_give_the_same_bits(cuda, b, r):
    # contiguous views 4 bytes past a 16-byte boundary take the kernel's
    # scalar staging path, with the same results as an aligned copy
    n, w = 40, b + 2 * r
    cur, win = (torch.from_numpy(x).to(cuda) for x in _sad_inputs(7, n, b, r))
    flat_c = torch.empty(n * b * b + 1, device=cuda)
    flat_w = torch.empty(n * w * w + 1, device=cuda)
    cur_v = flat_c[1:].view(n, b, b)
    win_v = flat_w[1:].view(n, w, w)
    cur_v.copy_(cur)
    win_v.copy_(win)
    assert cur_v.is_contiguous() and cur_v.data_ptr() % 16
    assert win_v.is_contiguous() and win_v.data_ptr() % 16
    before = sad_kernel.LAUNCHES.count
    got = sad_kernel.sad_search(cur_v, win_v)
    assert sad_kernel.LAUNCHES.count == before + 1
    _assert_same_bits(got, sad_kernel.sad_search(cur, win))
    _assert_same_bits(got, _sad_in_contract_order(cur, win))


# ------------------------------------------------------------ video server
def test_server_scan_on_cuda_bit_identical_to_execute(cuda, tmp_path):
    frames, dets = generate(sparse_spec(seed=4, n_frames=32, height=96,
                                        width=160))
    store = VideoStore(decode=DecodeConfig(device=str(cuda)),
                       cache=CacheConfig(budget_bytes=0),
                       tuning=TuningConfig(mode="off"))
    store.ingest("v", frames, detections=dets, policy=NoTilingPolicy())
    sock = str(tmp_path / "cuda.sock")
    try:
        with VideoStoreServer(store, path=sock, owns_store=False).start(), \
                RemoteVideoStore(sock, timeout=120) as client:
            assert client.config()["decode"].device.startswith("cuda")
            before = LAUNCHES.count
            got = client.scan("v").labels("car").frames(0, 32).execute()
            assert LAUNCHES.count > before
            want = store.scan("v").labels("car").frames(0, 32).execute()
            assert got.regions and len(got.regions) == len(want.regions)
            for g, w in zip(got.regions, want.regions):
                assert g[:-1] == w[:-1] and np.array_equal(g[-1], w[-1])
    finally:
        store.close()


# ------------------------------------------------------------ cluster
def test_cluster_failover_on_cuda_bit_identical(cuda, tmp_path):
    """Two in-process nodes on the card behind a K=2 router; the primary
    is stopped while a routed ``execute_many`` is in flight to it.  Every
    read returns, bit-identical to an in-process store on the card."""
    frames, dets = generate(sparse_spec(seed=6, n_frames=32, height=96,
                                        width=160))

    def mk():
        return VideoStore(decode=DecodeConfig(device=str(cuda)),
                          cache=CacheConfig(budget_bytes=0),
                          tuning=TuningConfig(mode="off"))

    ref = mk()
    ref.ingest("v", frames, detections=dets, policy=NoTilingPolicy())
    stores, servers, nodes = {}, {}, {}
    for n in ("n0", "n1"):
        stores[n] = mk()
        nodes[n] = str(tmp_path / f"{n}.sock")
        servers[n] = VideoStoreServer(stores[n], path=nodes[n],
                                      owns_store=False).start()
    router = ClusterRouter(nodes, replication=2, timeout=120)
    queries = [("car", (0, 32)), ("person", (8, 24)), ("car", (16, 32))]
    try:
        router.ingest("v", frames, detections=dets, policy=NoTilingPolicy())
        primary = router.placement.primary("v")
        want = [ref.scan("v").labels(lbl).frames(*fr).execute()
                for lbl, fr in queries]
        assert all(w.regions for w in want)
        ch = router._channel(primary)
        real = ch.execute_many
        in_flight, stopped = threading.Event(), threading.Event()

        def held(plans):
            in_flight.set()
            assert stopped.wait(timeout=120)
            return real(plans)

        ch.execute_many = held
        out, errors = [], []

        def batch():
            try:
                out.extend(router.execute_many(
                    [router.scan("v").labels(lbl).frames(*fr)
                     for lbl, fr in queries]))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        t = threading.Thread(target=batch)
        t.start()
        assert in_flight.wait(timeout=120)
        servers.pop(primary).stop()
        stopped.set()
        t.join(timeout=300)
        assert not t.is_alive() and not errors, errors
        assert primary in router._down
        again = router.execute_many([router.scan("v").labels(lbl)
                                     .frames(*fr) for lbl, fr in queries])
        for got in (out, again):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert len(g.regions) == len(w.regions)
                for rg, rw in zip(g.regions, w.regions):
                    assert rg[:-1] == rw[:-1]
                    assert np.array_equal(rg[-1], rw[-1])
        (survivor,) = [n for n in nodes if n != primary]
        assert stores[survivor].stats()["tiles_decoded_total"] > 0
        assert stores[primary].stats()["tiles_decoded_total"] == 0
    finally:
        router.close()
        for srv in servers.values():
            srv.stop()
        for st in stores.values():
            st.close()
        ref.close()


# --------------------------------------- encoder-decoder and VLM families
def _reduced_f32(arch, **kw):
    from repro_torch.configs.base import reduce_config

    return make_serve_config(dataclasses.replace(
        reduce_config(get_config(arch)), param_dtype="float32",
        compute_dtype="float32", head_dim=64, **kw), 1)


def test_encdec_prefill_on_the_card_matches_the_cpu(cuda):
    """Reduced seamless-m4t-medium in f32 at a head width of 64: the
    prefill encodes 24 frames and runs the decoder over 70 tokens, one
    launch per encoder layer and two per decoder layer (its self- and
    cross-attention, 70 queries over 24 keys), logits within 1e-4 of the
    CPU's on the same weights; greedy tokens over ``enc_out`` equal."""
    from repro_torch.models import Model, encode_frames
    from repro_torch.serve import greedy_generate

    cfg = _reduced_f32("seamless-m4t-medium")
    model = init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    cpu = Model(cfg, device="meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (2, 70))
    frames = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    before = flash_kernel.LAUNCHES.count
    got, _ = make_prefill_step(cfg, 80, device=str(cuda))(
        model, {"tokens": tokens, "frames": frames})
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count - before == (cfg.enc_layers
                                                     + 2 * cfg.n_layers)
    want, _ = make_prefill_step(cfg, 80, device="cpu")(
        cpu, {"tokens": tokens, "frames": frames})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    enc = encode_frames(model, cfg, torch.from_numpy(frames).to(cuda))
    card = greedy_generate(model, cfg, tokens, max_new=6, enc_out=enc,
                           device=str(cuda))
    host = greedy_generate(cpu, cfg, tokens, max_new=6,
                           enc_out=enc.cpu(), device="cpu")
    assert torch.equal(card.cpu(), host)


def test_vlm_patch_prefill_on_the_card_matches_the_cpu(cuda):
    """Reduced internvl2-26b in f32 at a head width of 64 (4 query heads
    on 1): a prefill of 8 patches and 40 tokens launches the kernel once
    per layer, its logits within 1e-4 of the CPU's on the same weights."""
    from repro_torch.models import Model

    cfg = _reduced_f32("internvl2-26b")
    model = init_model(cfg, torch.Generator(device=cuda).manual_seed(1),
                       device=cuda)
    cpu = Model(cfg, device="meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(6)
    batch = {"patch_embeds": rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32),
             "tokens": rng.integers(0, cfg.vocab, (2, 40))}
    before = flash_kernel.LAUNCHES.count
    got, _ = make_prefill_step(cfg, 64, device=str(cuda))(model, batch)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES.count - before == cfg.n_layers
    want, _ = make_prefill_step(cfg, 64, device="cpu")(cpu, batch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


# --------------------------------------- the tuner's race and entry points
def _small_video():
    """The small_video fixture's spec: its cars make RegretPolicy retile."""
    return generate(VideoSpec(
        height=96, width=160, n_frames=32, seed=5,
        objects=[ObjectSpec("car", 2, (16, 24), 2.0),
                 ObjectSpec("person", 1, (18, 10), 1.0)]))


def test_scans_racing_background_retiles_on_the_card(cuda):
    """Three client threads and a ``serve()`` session scan while the tuner
    thread re-encodes on the card (``tests/_torch_race.py``): every region
    bit for bit a serial inline store's on the card and within the decode
    oracle's tolerance, no query charged a retile, and a ``dct_quant``
    launch while a scan was in flight."""
    from _torch_race import check, race

    frames, dets = _small_video()
    before = LAUNCHES.count
    check(race(frames, dets, str(cuda), lambda: dct_kernel.LAUNCHES.count),
          must_race=True)
    assert LAUNCHES.count > before


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "incremental_workload_torch",
                                  "edge_tiling_torch"])
def test_video_examples_on_the_card(cuda, name, tmp_path):
    """The video examples' flows on the card: every contract they print
    holds, and each launched the decode and both encode kernels."""
    from _torch_entry import load

    mod = load(name)
    counts = (LAUNCHES, dct_kernel.LAUNCHES, idct_kernel.LAUNCHES)
    before = [c.count for c in counts]
    ok = (mod.run(str(tmp_path), str(cuda)) if name == "quickstart_torch"
          else mod.run(str(cuda)))
    assert ok and all(ok.values()), ok
    assert all(c.count > b for c, b in zip(counts, before))


def test_cluster_smoke_on_the_card(cuda):
    """``scripts/cluster_smoke_torch.py --device cuda``: three node
    processes and a router on the card, the kill, the repair and the
    clean shutdown."""
    from _torch_entry import run

    out = run("cluster_smoke_torch", "--device", "cuda", timeout=900)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "cluster_smoke_torch,0.0,ok"


# ------------------------------------------------ the FLOP count on the card
def _count_step(kind: str, device):
    """The reference-rule FLOP count of reduced smollm-135m's bf16 train
    step (B=2, S=64) or prefill (B=2, S=64) on ``device`` (``meta``: shapes
    only; the card: the step runs, through the kernels)."""
    from repro_torch.configs.base import ShapeSpec, reduce_config
    from repro_torch.launch.analytic_cost import count_flops, tiling_of
    from repro_torch.models import zoo

    cfg = dataclasses.replace(reduce_config(get_config("smollm-135m")),
                              head_dim=64, param_dtype="bfloat16")
    model = init_model(cfg, 0, device=device)
    spec = ShapeSpec("s", kind, 64, 2)
    batch = {k: (torch.empty(v.shape, dtype=v.dtype, device="meta")
                 if device == "meta" else torch.randint(
                     0, cfg.vocab, v.shape, dtype=v.dtype, device=device))
             for k, v in zoo.input_specs(cfg, spec).items()}
    if kind == "train":
        step = make_train_step(cfg)
        return count_flops(step, model,
                           init_opt_state(dict(model.named_parameters())),
                           batch, tiling=tiling_of(cfg))
    return count_flops(make_prefill_step(cfg, 64, device=device), model,
                       batch, tiling=tiling_of(cfg))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_count_on_meta_equals_count_on_the_card(cuda, kind):
    before = flash_kernel.LAUNCHES.count
    on_card = _count_step(kind, cuda)
    assert flash_kernel.LAUNCHES.count > before  # the kernels ran
    assert on_card == _count_step(kind, "meta") > 0


def test_flash_attention_at_the_32k_prefill_rows(cuda):
    """(1, 9, 3, 32,768, 64) bf16 causal, smollm-135m's prefill_32k
    heads: the first and the last 256 query rows against the plain
    version over all 32,768 keys (the plain scores of those rows only),
    each element within FLASH_TOL of its row's largest |plain| value: a
    last row averages about 32k keys, so its values are a few hundredths
    and an absolute limit of 2e-2 would hold nothing."""
    b, h, kv, s, d = 1, 9, 3, 32768, 64
    q, k, v = _qkv(s, b, h, kv, s, d, torch.bfloat16, cuda)
    got = flash_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    g = h // kv
    kr, vr = (x.float().repeat_interleave(g, 1) for x in (k, v))
    for start in (0, s - 256):
        rows = slice(start, start + 256)
        sc = q[:, :, rows].float() @ kr.transpose(-1, -2) / d ** 0.5
        pos = torch.arange(s, device=cuda)
        sc = sc.masked_fill(pos[None, :] > pos[rows][:, None], float("-inf"))
        want = torch.softmax(sc, dim=-1) @ vr
        scale = want.abs().amax(-1, keepdim=True)
        over = float(((got[:, :, rows].float() - want).abs() /
                      (FLASH_TOL[torch.bfloat16] * scale)).max())
        print(f"rows {start}-{start + 255}: over {over:.4f}, largest "
              f"|plain| {float(scale.max()):.4g}, smallest row's largest "
              f"{float(scale.min()):.4g}")
        assert over <= 1.0, (start, over)


@pytest.mark.parametrize("dims", [(2, 9, 3, 100, 64, 64, 64),
                                  (2, 16, 16, 64, 64, 192, 128),
                                  (2, 4, 2, 48, 17, 64, 64)])
def test_flash_attention_fn_on_meta_has_the_cards_shapes(cuda, dims):
    b, h, kv, s, skv, dqk, dv = dims
    causal = s == skv
    shapes = ((b, h, s, dqk), (b, kv, skv, dqk), (b, kv, skv, dv))
    out = {}
    for dev in (cuda, "meta"):
        q, k, v = (torch.randn(x, dtype=torch.bfloat16, device=dev)
                   .requires_grad_() for x in shapes)
        o = flash_kernel.flash_attention_op(q, k, v, causal=causal)
        grads = torch.autograd.grad(o.float().sum(), (q, k, v))
        out[str(dev)] = [(t.shape, t.dtype) for t in (o, *grads)]
    assert out["meta"] == out[str(cuda)]


# ------------------------------------------------------------ distributed/
RING_BLOCKS = 4


def _ring_blocks(q, k, v, causal):
    """``ring_step`` over ``RING_BLOCKS`` blocks of the sequence on one
    device, each query block over the key blocks in the ring's order (its
    own first, then the ones before it; those after it only when not
    causal)."""
    from repro_torch.distributed.ring_attention import ring_step

    B, S, KV, G, D = q.shape
    s = S // RING_BLOCKS
    out = []
    for i in range(RING_BLOCKS):
        qh = q[:, i * s:(i + 1) * s].permute(0, 2, 3, 1, 4).reshape(
            B, KV * G, s, D).contiguous()
        carry = None
        for hop in range(RING_BLOCKS):
            j = (i - hop) % RING_BLOCKS
            if causal and j > i:
                continue
            kb = k[:, j * s:(j + 1) * s].transpose(1, 2).contiguous()
            vb = v[:, j * s:(j + 1) * s].transpose(1, 2).contiguous()
            carry = ring_step(carry, qh, kb, vb, causal=causal and j == i)
        out.append(carry[0].reshape(B, KV, G, s, D).permute(0, 3, 1, 2, 4))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_step_blocks_match_plain_ring(cuda, dtype, causal):
    from repro_torch.distributed.ring_attention import ring_attention_ref

    g = torch.Generator(device=cuda).manual_seed(5)
    B, S, KV, G, D = 2, 512, 3, 3, 64
    q = torch.randn(B, S, KV, G, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, S, KV, D, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, S, KV, D, device=cuda, generator=g).to(dtype)
    before = flash_kernel.LAUNCHES.count
    got = _ring_blocks(q, k, v, causal)
    n = RING_BLOCKS * (RING_BLOCKS + 1) // 2 if causal else RING_BLOCKS ** 2
    assert flash_kernel.LAUNCHES.count - before == n
    want = ring_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() < 3e-5
    else:  # each row within 2e-2 of its own largest |plain| value
        err = (got - want).abs().amax(-1)
        assert (err <= 2e-2 * want.abs().amax(-1)).all()


@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_mesh

    mesh = init_mesh((1, 1), "cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


def _sharded_copy(cfg, mode, mesh):
    from repro_torch.distributed.sharding import shard_model

    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(3),
                       device="cuda")
    return shard_model(model, cfg, mesh, mode=mode)


def test_nccl_1x1_train_step_equals_unsharded(nccl_mesh):
    from repro_torch.configs.base import reduce_config
    from repro_torch.distributed.ctx import dp_rules, use_sharding
    from repro_torch.distributed.sharding import choose_policy

    cfg = families.kernel_widths(reduce_config(get_config("smollm-135m")),
                                 "bfloat16")
    mode = choose_policy(cfg, nccl_mesh)
    assert mode == "dp_train"
    plain = init_model(cfg, torch.Generator(device="cuda").manual_seed(3),
                       device="cuda")
    sharded = _sharded_copy(cfg, mode, nccl_mesh)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 65))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = make_train_step(cfg, opt_cfg)
    p_opt = init_opt_state(dict(plain.named_parameters()))
    s_opt = init_opt_state(dict(sharded.named_parameters()))
    for _ in range(2):
        _, p_opt, pm = step(plain, p_opt, batch)
        with use_sharding(dp_rules(nccl_mesh.axis_names), nccl_mesh):
            _, s_opt, sm = step(sharded, s_opt, batch)
        assert torch.equal(pm["loss"], sm["loss"])
        assert torch.equal(pm["grad_norm"], sm["grad_norm"])
    for (name, p), s in zip(plain.named_parameters(), sharded.parameters()):
        assert torch.equal(p, s.to_local()), name


@pytest.mark.parametrize("shard", ["heads", "seq"])
def test_nccl_1x1_decode_equals_unsharded(nccl_mesh, shard):
    from repro_torch.configs.base import reduce_config
    from repro_torch.distributed.ctx import SERVE_RULES_1POD, use_sharding
    from repro_torch.serve.serve_step import make_decode_step

    cfg = dataclasses.replace(make_serve_config(families.kernel_widths(
        reduce_config(get_config("smollm-135m")), "bfloat16"), 1),
        kv_cache_shard=shard)
    plain = init_model(cfg, torch.Generator(device="cuda").manual_seed(3),
                       device="cuda")
    sharded = _sharded_copy(cfg, "serve", nccl_mesh)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (4, 16))
    out = []
    for model, scope in ((plain, contextlib.nullcontext()),
                         (sharded, use_sharding(SERVE_RULES_1POD, nccl_mesh))):
        prefill = make_prefill_step(cfg, 24)
        decode = make_decode_step(cfg)
        with torch.no_grad(), scope:
            lg, caches = prefill(model, {"tokens": prompt})
            logits = [lg]
            for i in range(4):
                tok = torch.argmax(lg[:, -1:], -1)
                lg, caches = decode(model, caches, {"tokens": tok}, 16 + i)
                logits.append(lg)
        out.append(torch.cat(logits, dim=1))
    assert torch.equal(out[0], out[1])


def test_dtensor_never_reaches_a_kernel(nccl_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_lse_op, flash_attention_op)

    q = torch.randn(1, 2, 64, 64, device="cuda")
    dq = distribute_tensor(q, nccl_mesh.device_mesh,
                           [Replicate(), Replicate()])
    before = flash_kernel.LAUNCHES.count
    for call in (flash_attention_op, flash_attention_lse_op):
        with pytest.raises(TypeError, match="DTensor"):
            call(dq, dq, dq, causal=True)
    with pytest.raises(TypeError, match="DTensor"):
        flash_kernel.FlashAttentionFn.apply(dq, dq, dq, True, False)
    assert flash_kernel.LAUNCHES.count == before


MESH_FAMILIES = ("falcon-mamba-7b", "zamba2-1.2b", "seamless-m4t-medium",
                 "internvl2-26b")


@pytest.mark.parametrize("arch", MESH_FAMILIES)
def test_nccl_1x1_family_step_equals_unsharded(nccl_mesh, arch):
    """The SSM, hybrid, encoder-decoder and VLM families' bf16 loss and
    every gradient leaf, FSDP + TP (``train``) on the 1x1 NCCL mesh, bit
    for bit the unsharded model's (every group of one rank is no group:
    the one-device code runs)."""
    from repro_torch.configs.base import reduce_config
    from repro_torch.distributed.ctx import TRAIN_RULES_1POD, use_sharding

    cfg = families.kernel_widths(reduce_config(get_config(arch)), "bfloat16")
    plain = init_model(cfg, torch.Generator(device="cuda").manual_seed(3),
                       device="cuda")
    sharded = _sharded_copy(cfg, "train", nccl_mesh)
    batch = {k: torch.as_tensor(v).cuda() for k, v in families.batch(
        cfg, 4, 64, np.random.default_rng(2)).items()}
    lp, gp = _loss_and_grads(plain, cfg, batch)
    with use_sharding(TRAIN_RULES_1POD, nccl_mesh):
        ls, gs = _loss_and_grads(sharded, cfg, batch)
    assert torch.equal(lp, ls)
    for name, g in gp.items():
        assert torch.equal(g, gs[name].to_local()), name


def test_split_products_sum_in_f32_on_the_card(cuda):
    """The products a mesh splits, on the card: ``parallel._mm_f32`` of
    bf16 operands (cuBLAS's f32 output) within 1e-5 of the largest value
    of the upcast product on the CPU; ``layers.dense_cols`` the forward
    of ``dense_apply`` bit for bit, its input gradient rounded once from
    the same sums as on the CPU (the two roundings of sums taken in
    another order at most one bf16 ulp apart) and its weight
    gradients in f32 (within 1e-5 of their largest value); and
    ``parallel.row_product`` with no group ``_mm_f32`` itself."""
    from types import SimpleNamespace

    from repro_torch.distributed import parallel
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(3)
    a = torch.randn(300, 520, generator=g).bfloat16()
    b = torch.randn(520, 200, generator=g).bfloat16()
    want = a.float() @ b.float()
    got = parallel._mm_f32(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(parallel.row_product(a.to(cuda), b.to(cuda)), got)

    x = torch.randn(4, 64, 256, generator=g).bfloat16()
    ps = [layers.Dense(256, n, dtype="float32", generator=g)
          for n in (384, 128)]
    gys = [torch.randn(4, 64, n, generator=g).bfloat16() for n in (384, 128)]
    runs = {}
    for dev in ("cpu", cuda):
        tx = x.detach().to(dev).requires_grad_(True)
        ws = [p.w.detach().to(dev).requires_grad_(True) for p in ps]
        qs = [SimpleNamespace(w=w, b=None) for w in ws]
        ys = layers.dense_cols(qs, tx, "bfloat16")
        for q, y in zip(qs, ys):
            assert torch.equal(y, layers.dense_apply(q, tx.detach(),
                                                     "bfloat16"))
        torch.autograd.backward(ys, [gy.to(dev) for gy in gys])
        runs[str(dev)] = [tx.grad.float().cpu()] + [w.grad.cpu() for w in ws]
    cpu, card = runs["cpu"], runs[str(cuda)]
    torch.testing.assert_close(card[0], cpu[0], rtol=2.0 ** -7, atol=1e-6)
    for got, want in zip(card[1:], cpu[1:]):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())
