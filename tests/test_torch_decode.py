"""The port's fused decode (``repro_torch.kernels.decode``) against the JAX
reference's: the plain PyTorch version against the Pallas kernel run in
interpret mode and against the jnp reference, the size bucketing, and the
CPU/CUDA dispatch.  Inputs are made with numpy from a seed and handed to
both packages.  Tolerance: ``atol=1e-3, rtol=1e-5`` on pixel-scale output
(the two packages sum the 8x8 products in different orders)."""
import numpy as np
import pytest
import torch

from repro.kernels.decode import decode_fused_ref as jax_decode_fused_ref
from repro.kernels.decode import pad_bucket as jax_pad_bucket
from repro.kernels.decode.ops import decode_fused_op as jax_decode_fused_op
from repro_torch.kernels.decode import (LAUNCHES, MIN_COLUMNS,
                                        decode_fused_op, decode_fused_ref,
                                        decode_gop_blocks, pad_bucket)
from test_torch_cuda import random_stream

ATOL, RTOL = 1e-3, 1e-5


@pytest.mark.parametrize("qp", [4, 8, 12])
@pytest.mark.parametrize("n_frames", [1, 4, 16])
def test_ref_matches_pallas_interpret_and_jnp_ref(n_frames, qp):
    rng = np.random.default_rng(100 * n_frames + qp)
    q = random_stream(rng, n_frames, 128, qp)
    got = decode_fused_ref(torch.from_numpy(q), qp)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    got = got.numpy()
    pallas = np.asarray(jax_decode_fused_op(q, qp=qp, use_pallas=True,
                                            interpret=True))
    jnp_ref = np.asarray(jax_decode_fused_ref(q, qp))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, jnp_ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("m", [1, 63, 64, 65, 300])
def test_op_pads_columns_and_matches_ref(m):
    rng = np.random.default_rng(m)
    q = random_stream(rng, 4, m, 8)
    got = decode_fused_op(torch.from_numpy(q), qp=8)
    assert tuple(got.shape) == q.shape
    want = np.asarray(jax_decode_fused_op(q, qp=8, use_pallas=False))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_column_result_independent_of_batch():
    # serial, merged and served scans stay bit-identical only if a column
    # decodes the same wherever it sits in whatever stream
    rng = np.random.default_rng(5)
    q = torch.from_numpy(random_stream(rng, 8, 200, 8))
    whole = decode_fused_op(q, qp=8)
    for lo, hi in [(0, 1), (17, 80), (150, 200)]:
        part = decode_fused_op(q[:, lo:hi].contiguous(), qp=8)
        assert torch.equal(part, whole[:, lo:hi])


def test_trailing_zero_frames_do_not_perturb_prefix():
    # codec.batch pads GOP depth with zero rows and slices them off
    rng = np.random.default_rng(9)
    q = random_stream(rng, 5, 64, 8)
    padded = np.concatenate([q, np.zeros((3, 64, 8, 8), np.int16)])
    a = decode_fused_op(torch.from_numpy(q), qp=8)
    b = decode_fused_op(torch.from_numpy(padded), qp=8)
    assert torch.equal(a, b[:5])


@pytest.mark.parametrize("lo", [1, 8, MIN_COLUMNS])
def test_pad_bucket_matches_reference(lo):
    for n in list(range(1, 300)) + [1 << 14, (1 << 14) + 1, 32400]:
        b = pad_bucket(n, lo)
        assert b == jax_pad_bucket(n, lo)
        assert b >= max(n, lo) and (b & (b - 1) == 0 or b == lo)


def test_kernel_wrapper_rejects_cpu_tensor_without_launching():
    before = LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_gop_blocks(torch.zeros((1, 64, 8, 8), dtype=torch.int16), 8)
    assert LAUNCHES.count == before
