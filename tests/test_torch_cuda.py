"""The CUDA kernels on the card: each against its plain PyTorch version,
block by block independent of the batch, and under the batched decode,
the device encoder, the engine, the video server, the cluster router and
LM serving against the numpy oracles and the plain versions.  Marked
``cuda``; each test skips where no CUDA device is present.  This file
imports no JAX, so it also runs where only the port is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
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
from repro_torch.kernels import sad as sad_kernel
from repro_torch.kernels.decode import (LAUNCHES, decode_fused_ref,
                                        decode_gop_blocks)
from repro_torch.models import attention as attention_mod
from repro_torch.models import init_model, loss_fn
from repro_torch.serve import ContinuousBatcher, make_prefill_step
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_train_step

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
@pytest.mark.parametrize("g", [1, 3, 8])
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
        h, kv, s, d, flash_kernel.flash.DTYPES[dtype], 1, d ** -0.5,
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
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("s", [1, 63, 64, 257, 1500, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_matches_plain_version(cuda, dtype, d, g, s,
                                                   causal):
    q, k, v, o, lse, dout = _bwd_case(cuda, s + d + g, 1, g, 2, s, d, dtype,
                                      causal)
    before = flash_kernel.BWD_LAUNCHES.count
    got = flash_kernel.flash_attention_bwd(q, k, v, o, dout, lse,
                                           causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.BWD_LAUNCHES.count == before + 1
    want = flash_kernel.attention_bwd_ref(
        q, k, v, flash_kernel.attention_ref(q, k, v, causal=causal), dout,
        flash_kernel.attention_lse_ref(q, k, causal=causal), causal=causal)
    floor = BWD_FLOOR * max(float(w.float().abs().max()) for w in want)
    for name, a, w, x in zip("qkv", got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape, name
        err = _row_scaled_err(a, w, floor)
        assert err <= BWD_TOL[dtype], (
            f"d{name}: {err} of its row's largest > {BWD_TOL[dtype]}")


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
