"""The port's attention kernel entry (``repro_torch.kernels.flash_attention``)
against the JAX reference's: the plain PyTorch version (the CPU path of
``flash_attention_op``) against the Pallas kernel run in interpret mode and
against the jnp ``attention_ref``, on the sweep of ``tests/test_kernels.py``
and at odd sequence lengths.  Inputs are made with numpy from a seed, cast
to bf16 (round to nearest even in both packages) where the case asks, and
handed to both.

Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
f32 and 2e-2 in bf16, where one output ulp near 1 is 7.8e-3.  Keys of
another length than the queries (not causal: cross-attention) are held
against the reference's chunked attention at the same tolerances.

The gradient (``FlashAttentionFn``, whose CPU backward is
``attention_bwd_ref``) is held against ``jax.grad`` through the
reference's chunked attention at rtol 1e-5 and atol 1e-6 x max|g|, and
``attention_bwd_ref`` against torch's autograd of ``attention_ref``.  The
backward kernel's bf16 design (``attention_bwd_bf16_mma_ref``: P and dS
as two bf16 parts before the second products) is held against
``attention_bwd_ref`` with the card's per-row rule."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention_op as jax_flash_attention_op)
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro.models import attention as jax_attention
from repro.models.attention import grouped_attention as jax_grouped
from repro_torch.kernels.flash_attention import (LAUNCHES, FlashAttentionFn,
                                                 attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_op)
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.kernels.flash_attention.ref import (
    attention_bf16_mma_ref, attention_bwd_bf16_mma_ref)
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
                                      (256, 8, 1, 32), (128, 7, 1, 32)])
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
    out = flash_attention_op(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        attention_ops._device(SimpleNamespace(device=torch.device("xpu")))
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


# --------------------------------------- keys of another length (not causal)
#: (B, H, KV, S, Skv, Dqk, Dv): the encoder-decoder's cross-attention at
#: seamless-m4t-medium's serving shape, keys longer than queries, a ragged
#: last key tile, G > 1, and every (q.k, v) pair of the CUDA kernel
CROSS_CASES = [(8, 16, 16, 512, 128, 64, 64), (2, 4, 2, 256, 100, 64, 64),
               (3, 8, 8, 100, 37, 128, 128), (2, 4, 4, 64, 256, 32, 32),
               (1, 16, 16, 128, 512, 192, 128)]


def _cross_inputs(case, dtype, seed=0):
    """numpy q [B, S, KV, G, Dqk], k [B, Skv, KV, Dqk], v [B, Skv, KV,
    Dv], rounded through ``dtype``, in the reference's layout."""
    b, h, kv, s, skv, d, dv = case
    rng = np.random.default_rng(seed + s + skv)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, kv, h // kv, d), (b, skv, kv, d),
                          (b, skv, kv, dv))]
    return [np.array(jnp.asarray(a).astype(dtype).astype(jnp.float32))
            for a in arrs]


def _kv_chunk(skv):
    return max(c for c in range(1, 65) if skv % c == 0)


@pytest.mark.parametrize("case", CROSS_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_lengths_match_reference_chunked(case, dtype):
    """The plain version (the CPU path of ``flash_attention_op``) with
    S queries over Skv keys, not causal, against the reference's chunked
    attention (its cross-attention path: ``q_pos = arange(S)``,
    ``kv_pos = arange(Skv)``), within the reference's tolerance of the
    dtype; the inputs are the same bf16-rounded values in both."""
    b, h, kv, s, skv, d, dv = case
    q, k, v = _cross_inputs(case, dtype)
    want = jax_attention._chunked_attention(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)), causal=False,
        q_pos=jnp.arange(s), kv_pos=jnp.arange(skv), q_chunk=64,
        kv_chunk=_kv_chunk(skv))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    tq = tq.permute(0, 2, 3, 1, 4).reshape(b, h, s, d)
    tk = torch.from_numpy(k).to(getattr(torch, dtype)).transpose(1, 2)
    tv = torch.from_numpy(v).to(getattr(torch, dtype)).transpose(1, 2)
    before = LAUNCHES.count
    got = flash_attention_op(tq.contiguous(), tk.contiguous(),
                             tv.contiguous(), causal=False)
    assert LAUNCHES.count == before
    assert got.shape == (b, h, s, dv)
    got = got.reshape(b, kv, h // kv, s, dv).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("case", CROSS_CASES[1:], ids=str)
def test_cross_lengths_bf16_kernel_rounding_within_tolerance(case):
    """The bf16 kernel's rounding (64-key tiles, P as two bf16 parts) over
    keys of another length, within 2e-2 of the plain version."""
    b, h, kv, s, skv, d, dv = case
    rng = np.random.default_rng(s * skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .bfloat16() for shape in ((b, h, s, d), (b, kv, skv, d),
                                         (b, kv, skv, dv)))
    got = attention_bf16_mma_ref(q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    assert float((got.float() - want.float()).abs().max()) <= TOL["bfloat16"]


def test_causal_with_two_lengths_raises():
    q, k, v = (torch.zeros(shape) for shape in ((1, 2, 8, 16), (1, 2, 5, 16),
                                                (1, 2, 5, 16)))
    for fn in (attention_ref, flash_attention_op, attention_bf16_mma_ref):
        with pytest.raises(ValueError, match="causal"):
            fn(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        attention_lse_ref(q, k, causal=True)


@pytest.mark.parametrize("kv,g,d", [(2, 3, 16), (4, 1, 64),
                                    (2, 2, (192, 128))])
def test_cross_attention_gradient_matches_jax_grad(kv, g, d):
    """The plain backward at S = 40 queries over Skv = 24 keys (the CPU
    path of cross-attention training; 24 is a ragged tile of the kernel's
    64), at one head width or at MLA's (q.k 192, v 128), against
    ``jax.grad`` through the reference's chunked attention, at the
    tolerances of the gradient test below."""
    b, s, skv = 2, 40, 24
    d, dv = d if isinstance(d, tuple) else (d, d)
    rng = np.random.default_rng(kv * 10 + g + d)
    q = rng.standard_normal((b, s, kv, g, d), dtype=np.float32)
    k = rng.standard_normal((b, skv, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, skv, kv, dv), dtype=np.float32)
    dout = rng.standard_normal((b, s, kv, g, dv), dtype=np.float32)

    def f(q, k, v):
        out = jax_grouped(q, k, v, causal=False, q_pos=jnp.arange(s),
                          kv_pos=jnp.arange(skv), impl="chunked",
                          q_chunk=8, kv_chunk=8)
        return jnp.sum(out * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.grouped_attention(tq, tk, tv, causal=False,
                                      q_pos=torch.arange(s),
                                      kv_pos=torch.arange(skv),
                                      impl="chunked")
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=f"d{name}")


# ------------------------------------------------------- attention gradient
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv,g,d", [(2, 3, 16), (1, 4, 32), (3, 1, 64),
                                    (2, 2, (192, 128)), (1, 7, 32)])
def test_attention_gradient_matches_jax_grad(causal, kv, g, d):
    # the port's FlashAttentionFn (plain backward on the CPU) against
    # jax.grad through the reference's chunked online-softmax attention;
    # d is one head width, or MLA's (q.k, v) widths
    b, s = 2, 48
    d, dv = d if isinstance(d, tuple) else (d, d)
    rng = np.random.default_rng(kv * 10 + g + d)
    q = rng.standard_normal((b, s, kv, g, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, dv), dtype=np.float32)
    dout = rng.standard_normal((b, s, kv, g, dv), dtype=np.float32)
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


# ------------------------------------------ the backward kernel's bf16 design
#: the card's rule (tests/test_torch_cuda.py, chip_smoke.py): each element
#: over its row's largest |gradient| (over D), that scale at least
#: BWD_FLOOR of the call's largest; bf16 one ulp of the row's largest
#: (2^-7) and some f32 noise
BWD_TOL_BF16 = 1e-2
BWD_FLOOR = 1e-2
#: the split's error before the final rounding, of the row's largest:
#: P and dS keep about 16 bits (a bf16 ulp of the remainder, ~2^-17 of
#: each value), summed over the keys or rows of a product
SPLIT_TOL = 1e-4


def _row_scaled_errs(got, want):
    floor = BWD_FLOOR * max(float(w.float().abs().max()) for w in want)
    errs = []
    for a, w in zip(got, want):
        w = w.float()
        row = w.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
        errs.append(float(((a.float() - w).abs() / row).max()))
    return errs


def _bwd_inputs(seed, b, h, kv, s, d, causal):
    """bf16 q, k, v, dO from a seed (standard normal, as the card's tests
    make them), and the plain o and lse; ``s`` is one length or (S, Skv),
    ``d`` one width or (Dqk, Dv)."""
    s, skv = s if isinstance(s, tuple) else (s, s)
    d, dv = d if isinstance(d, tuple) else (d, d)
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).bfloat16() for shape in (
        (b, h, s, d), (b, kv, skv, d), (b, kv, skv, dv), (b, h, s, dv)))
    o = attention_ref(q, k, v, causal=causal)
    lse = attention_lse_ref(q, k, causal=causal)
    return q, k, v, o, dout, lse


@pytest.mark.parametrize("b,h,kv,s,d,causal", [
    (*shape, causal) for shape in (
        (2, 4, 4, 128, 32), (2, 4, 2, 256, 64), (2, 8, 1, 256, 32),
        (3, 9, 3, 1, 64), (3, 9, 3, 7, 64), (3, 9, 3, 100, 64),
        (2, 4, 2, 100, (192, 128)), (1, 4, 4, 1, (192, 128)))
    for causal in (True, False)] + [(1, 9, 3, 2048, 64, True)] + [
    # keys of another length (not causal): seamless' 4:1 cross-attention,
    # the ragged 96 over 40, keys longer than queries, MLA's widths
    (2, 4, 4, (128, 32), 64, False), (2, 4, 2, (96, 40), 64, False),
    (1, 4, 2, (33, 130), 32, False), (2, 4, 2, (96, 40), (192, 128), False)],
    ids=str)
def test_bf16_bwd_rounding_within_tolerance(b, h, kv, s, d, causal):
    """What the CPU can say of the backward kernel's bf16 design: P and dS
    split into bf16 hi + lo parts before the second products stays inside
    the card's per-row bf16 limit of the plain gradient, and before the
    final rounding within SPLIT_TOL of it; P and dS rounded to bf16 alone
    (the rejected design) lose at least ten times as much, at the
    kernel's width pairs and at keys of another length.  The kernel itself
    is held on the card (``tests/test_torch_cuda.py``)."""
    q, k, v, o, dout, lse = _bwd_inputs(
        int(np.sum(s) + np.sum(d)) + h, b, h, kv, s, d, causal)
    want = attention_bwd_ref(q, k, v, o, dout, lse, causal=causal)
    got = attention_bwd_bf16_mma_ref(q, k, v, o, dout, lse, causal=causal)
    for a, x in zip(got, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == x.shape
    for name, err in zip(("dq", "dk", "dv"), _row_scaled_errs(got, want)):
        assert err <= BWD_TOL_BF16, f"{name}: {err} > {BWD_TOL_BF16}"
    # before the final rounding: f32 copies of the bf16 inputs
    f32 = [x.float() for x in (q, k, v, o, dout)]
    exact = attention_bwd_ref(*f32, lse, causal=causal)
    split = _row_scaled_errs(
        attention_bwd_bf16_mma_ref(*f32, lse, causal=causal), exact)
    hi = _row_scaled_errs(attention_bwd_bf16_mma_ref(
        *f32, lse, causal=causal, split=False), exact)
    assert max(split) <= SPLIT_TOL, split
    if k.shape[2] > 1:  # one key: P = 1 and dS = 0 are exact in bf16
        assert max(hi) >= 10 * max(split), (hi, split)
