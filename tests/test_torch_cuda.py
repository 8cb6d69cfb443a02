"""The CUDA decode kernel on the card: against its plain PyTorch version,
column by column independent of the batch, and under the batched decode
and the engine against the numpy oracle.  Marked ``cuda``; each test skips
where no CUDA device is present.  This file imports no JAX, so it also runs
where only the port is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.codec.batch import decode_tile_batch
from repro_torch.codec.encode import EncoderConfig, decode_tile, encode_tile
from repro_torch.core import (CacheConfig, DecodeConfig, VideoStore,
                              uniform_layout)
from repro_torch.data.video_gen import generate, sparse_spec
from repro_torch.kernels.decode import (LAUNCHES, decode_fused_ref,
                                        decode_gop_blocks)

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
                                        (3, 5)])
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
    q = torch.from_numpy(random_stream(np.random.default_rng(1), 16, 777,
                                       8)).to(cuda)
    whole = decode_gop_blocks(q, 8)
    for lo, hi in [(0, 1), (3, 260), (700, 777)]:
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
