"""The port's attention kernel entry (``repro_torch.kernels.flash_attention``)
against the JAX reference's: the plain PyTorch version (the CPU path of
``flash_attention_op``) against the Pallas kernel run in interpret mode and
against the jnp ``attention_ref``, on the sweep of ``tests/test_kernels.py``
and at odd sequence lengths.  Inputs are made with numpy from a seed, cast
to bf16 (round to nearest even in both packages) where the case asks, and
handed to both.

Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
f32 and 2e-2 in bf16, where one output ulp near 1 is 7.8e-3.

The gradient (``FlashAttentionFn``, whose CPU backward is
``attention_bwd_ref``) is held against ``jax.grad`` through the
reference's chunked attention at rtol 1e-5 and atol 1e-6 x max|g|, and
``attention_bwd_ref`` against torch's autograd of ``attention_ref``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention_op as jax_flash_attention_op)
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro.models.attention import grouped_attention as jax_grouped
from repro_torch.kernels.flash_attention import (LAUNCHES, FlashAttentionFn,
                                                 attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_op)
from repro_torch.kernels.flash_attention.ref import attention_bf16_mma_ref
from repro_torch.models import attention

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


# ------------------------------------------------------- attention gradient
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv,g,d", [(2, 3, 16), (1, 4, 32), (3, 1, 64)])
def test_attention_gradient_matches_jax_grad(causal, kv, g, d):
    # the port's FlashAttentionFn (plain backward on the CPU) against
    # jax.grad through the reference's chunked online-softmax attention
    b, s = 2, 48
    rng = np.random.default_rng(kv * 10 + g + d)
    q = rng.standard_normal((b, s, kv, g, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    dout = rng.standard_normal((b, s, kv, g, d), dtype=np.float32)
    pos = jnp.arange(s)

    def f(q, k, v):
        out = jax_grouped(q, k, v, causal=causal, q_pos=pos, kv_pos=pos,
                          impl="chunked", q_chunk=16, kv_chunk=16)
        return jnp.sum(out * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tpos = torch.arange(s)
    out = attention.grouped_attention(tq, tk, tv, causal=causal, q_pos=tpos,
                                      kv_pos=tpos, impl="chunked")
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kv,s,d", [(2, 6, 2, 37, 32), (1, 3, 3, 64, 16),
                                        (2, 4, 1, 1, 64)])
def test_attention_bwd_ref_matches_autograd(b, h, kv, s, d, causal, dtype):
    rng = np.random.default_rng(s + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dtype).requires_grad_()
               for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    dout = torch.from_numpy(rng.standard_normal((b, h, s, d),
                                                dtype=np.float32)).to(dtype)
    # autograd of the plain forward, in f32 from the same inputs
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    out = attention_ref(qf, kf, vf, causal=causal)
    want = torch.autograd.grad(out, (qf, kf, vf), dout.float())
    lse = attention_lse_ref(q.detach(), k.detach(), causal=causal)
    o = attention_ref(q.detach(), k.detach(), v.detach(), causal=causal)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, dout, lse,
                            causal=causal)
    # f32: the same function; bf16: o and the gradients rounded to bf16.
    # Relative to the largest gradient of the three: at S = 1, dq and dk
    # are 0 up to rounding
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = max(float(w.abs().max()) for w in want)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w, rtol=0, atol=tol * scale)


def test_flash_attention_fn_saves_only_with_grad():
    q, k, v = (torch.randn(1, 2, 8, 16) for _ in range(3))
    with torch.no_grad():
        out = attention.flash_attention_op(q, k, v)
    assert out.grad_fn is None
    out = FlashAttentionFn.apply(q.requires_grad_(), k, v, True, False)
    with pytest.raises(RuntimeError, match="save=False"):
        out.sum().backward()
