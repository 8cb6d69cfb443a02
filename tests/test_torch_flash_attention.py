"""The port's attention kernel entry (``repro_torch.kernels.flash_attention``)
against the JAX reference's: the plain PyTorch version (the CPU path of
``flash_attention_op``) against the Pallas kernel run in interpret mode and
against the jnp ``attention_ref``, on the sweep of ``tests/test_kernels.py``
and at odd sequence lengths.  Inputs are made with numpy from a seed, cast
to bf16 (round to nearest even in both packages) where the case asks, and
handed to both.

Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
f32 and 2e-2 in bf16, where one output ulp near 1 is 7.8e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention_op as jax_flash_attention_op)
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import (LAUNCHES, attention_ref,
                                                 flash_attention,
                                                 flash_attention_op)
from repro_torch.kernels.flash_attention.ref import attention_bf16_mma_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, h, kv, s, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _compare(b, h, kv, s, d, causal, dtype, seed=0):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed, b, h, kv, s, d, dtype)
    before = LAUNCHES.count
    got = flash_attention_op(tq, tk, tv, causal=causal)
    assert LAUNCHES.count == before  # the CPU path launches no kernel
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jax_flash_attention_op(jq, jk, jv, causal=causal, bq=64,
                                    bkv=64, interpret=True)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol)


@pytest.mark.parametrize("s,h,kv,d", [(128, 4, 4, 32), (256, 4, 2, 64),
                                      (256, 8, 1, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(s, h, kv, d, causal, dtype):
    _compare(2, h, kv, s, d, causal, dtype)


@pytest.mark.parametrize("s", [1, 7, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_odd_lengths(s, causal, dtype):
    # smollm's heads: 9 query heads on 3 KV heads, head dim 64
    _compare(3, 9, 3, s, 64, causal, dtype, seed=s)


def test_plain_version_matches_reference_oracle_in_f32():
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, 2, 6, 2, 96, 32, "float32")
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(attention_ref(tq, tk, tv, causal=causal)),
            _np(jax_attention_ref(jq, jk, jv, causal=causal)), atol=2e-6)


@pytest.mark.parametrize("cut", [1, 37, 64, 99])
def test_causal_row_ignores_later_positions(cut):
    _, (q, k, v) = _inputs(7, 2, 4, 2, 100, 32, "float32")
    out = flash_attention_op(q, k, v, causal=True)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[:, :, cut:] = 50.0
    k2[:, :, cut:] = -50.0
    v2[:, :, cut:] = 1e4
    out2 = flash_attention_op(q2, k2, v2, causal=True)
    assert torch.equal(out[:, :, :cut], out2[:, :, :cut])
    assert not torch.equal(out[:, :, cut:], out2[:, :, cut:])


def test_kv_head_of_query_head_is_h_over_group():
    """Query head ``hh`` reads KV head ``hh // (H / KV)``: zeroing the
    values of KV head 1 zeroes exactly query heads 3..5 of 9 on 3."""
    _, (q, k, v) = _inputs(11, 1, 9, 3, 20, 32, "float32")
    v[:, 1] = 0.0
    out = flash_attention_op(q, k, v, causal=False)
    assert torch.equal(out[:, 3:6], torch.zeros_like(out[:, 3:6]))
    assert (out[:, :3].abs().amax() > 0) and (out[:, 6:].abs().amax() > 0)


def test_wrapper_needs_cuda_tensors():
    _, (q, k, v) = _inputs(0, 1, 2, 1, 8, 32, "float32")
    before = LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_op(q.to("meta"), k.to("meta"), v.to("meta"))
    assert LAUNCHES.count == before


@pytest.mark.parametrize("b,h,kv,s,d", [
    (2, 4, 4, 128, 32), (2, 4, 2, 256, 64), (2, 8, 1, 256, 32),
    (3, 9, 3, 1, 64), (3, 9, 3, 7, 64), (3, 9, 3, 100, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_rounding_within_tolerance(b, h, kv, s, d, causal):
    """What the CPU can say of the bf16 kernel's design: its extra
    rounding (P as two bf16 parts before PV) stays inside the bf16
    tolerance of the plain version and of the Pallas kernel (interpret
    mode) on the sweep's shapes.  The kernel itself is held on the card
    (``tests/test_torch_cuda.py``)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(s + d, b, h, kv, s, d, "bfloat16")
    got = attention_bf16_mma_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    pallas = jax_flash_attention_op(jq, jk, jv, causal=causal, bq=64,
                                    bkv=64, interpret=True)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(attention_ref(tq, tk, tv, causal=causal)), atol=tol)
