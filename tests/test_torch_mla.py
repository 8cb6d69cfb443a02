"""MLA attention and the int8 KV cache on the port against the JAX
reference on the CPU: the plain attention at a q.k width of 192 against a
v width of 128 (the CPU path of ``FlashAttentionFn``) against the
reference's chunked and naive attention; ``mla_apply`` full-sequence
(``q_lora_rank`` 0 and > 0), a prefill into the latent cache and absorbed
decode steps, and the absorbed decode against the materialised longer
prefill; ``_kv_quant`` codes and scales; decode on the int8 cache for GQA
(reduced ``smollm-135m``) and MLA; and reduced ``deepseek-v2-lite-16b``
with MLA kept, as a whole model: ``greedy_generate``, the batcher, the
loss and every gradient leaf through the plain backward at Dv != Dqk.
Weights are the reference's, carried across by ``params_from_numpy``;
inputs are made with numpy from a seed.

Tolerances: the attention and one MLA layer within 1e-5 (both compute in
f32 and differ only in summation order); a prefill plus decode steps,
absorbed or not, within 1e-4; whole-model logits within 1e-3 with at
least 99 % of greedy tokens equal; the training oracle's loss rtol 1e-5
and per-leaf gradients 1e-4 of the leaf's largest value.  Whole-model
cases check the MoE gate gaps first (``GateGaps``, as the MoE tests)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import attention as jax_attention
from repro.models import zoo as jax_zoo
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 attention_ref)
from repro_torch.kernels.flash_attention.ref import attention_bf16_mma_ref
from repro_torch.models import attention, params_from_numpy, zoo
from repro_torch.serve import ContinuousBatcher, greedy_generate
from test_torch_moe import GateGaps

DEEPSEEK, SMOLLM = "deepseek-v2-lite-16b", "smollm-135m"
F32 = dict(param_dtype="float32", compute_dtype="float32")
DQK, DV = 192, 128


def _reduced(arch, **kw):
    """The reference's and the port's reduced f32 config of ``arch`` with
    ``kw`` (DeepSeek keeps MLA: q.k 16 + 8, v 16, latent rank 32)."""
    kw = {**F32, **kw}
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)), **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


def _mla_cfgs(**mla):
    jcfg, tcfg = _reduced(DEEPSEEK)
    return (dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla,
                                                               **mla)),
            dataclasses.replace(tcfg, mla=dataclasses.replace(tcfg.mla,
                                                               **mla)))


def _carried(jcfg, tcfg, seed=0):
    params = jax_zoo.init_model(jcfg, jax.random.key(seed))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return params, model


def _layer0(params, model):
    """The first MoE layer's attention: the reference's and the port's."""
    return (jax.tree.map(lambda a: a[0], params["layers"]["attn"]),
            model.layers[0].attn)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


# ------------------------------------------ plain attention at 192 / 128
@pytest.mark.parametrize("b,kv,g,s", [(2, 2, 3, 100), (1, 4, 1, 64),
                                      (2, 1, 2, 37)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_192_128_matches_reference(b, kv, g, s, causal):
    """``FlashAttentionFn`` on the CPU against the reference's chunked
    (its prefill path; chunks dividing S) and naive attention, within
    1e-5: G query heads on a KV head, a ragged S, the scale 1/sqrt(192)
    and the output at v's width."""
    rng = np.random.default_rng(s * 10 + g)
    q = rng.standard_normal((b, s, kv, g, DQK), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, DQK), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, DV), dtype=np.float32)
    pos = jnp.arange(s)
    chunk = max(c for c in (8, 16, 32, 37, 50) if s % c == 0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    chunked = jax_attention._chunked_attention(
        jq, jk, jv, causal=causal, q_pos=pos, kv_pos=pos, q_chunk=chunk,
        kv_chunk=chunk)
    naive = jax_attention._naive_attention(jq, jk, jv, causal=causal,
                                           q_pos=pos, kv_pos=pos)
    tq = torch.from_numpy(q).permute(0, 2, 3, 1, 4).reshape(b, kv * g, s, DQK)
    got = FlashAttentionFn.apply(tq, torch.from_numpy(k).transpose(1, 2),
                                 torch.from_numpy(v).transpose(1, 2), causal,
                                 False)
    assert got.shape == (b, kv * g, s, DV)
    got = got.reshape(b, kv, g, s, DV).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(np32(got), np32(chunked), atol=1e-5)
    np.testing.assert_allclose(np32(got), np32(naive), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_rounding_at_192_128_within_tolerance(causal):
    """The bf16 kernel's rounding (P as two bf16 parts before PV) at the
    MLA widths stays within the bf16 tolerance 2e-2 of the plain
    version."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .bfloat16() for shape in ((2, 4, 100, DQK), (2, 4, 100, DQK),
                                         (2, 4, 100, DV)))
    got = attention_bf16_mma_ref(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    assert got.shape == want.shape == (2, 4, 100, DV)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-2)


# ------------------------------------------------------------ MLA module
@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_params_from_numpy_rejects_a_wrong_mla_tree(fault):
    """The MLA leaves cross by name: a missing ``wkv_b``, or a
    ``wq_a`` that a full-rank query (``q_lora_rank`` 0) does not have,
    raises."""
    jcfg, tcfg = _reduced(DEEPSEEK)
    tree = jax.tree.map(np.asarray, jax_zoo.init_model(jcfg,
                                                       jax.random.key(0)))
    attn = tree["layers"]["attn"]
    if fault == "missing":
        del attn["wkv_b"]
    else:
        attn["wq_a"] = {"w": np.zeros(attn["wq"]["w"].shape, np.float32)}
    with pytest.raises(ValueError, match=fault):
        params_from_numpy(tcfg, tree, device="cpu")


@pytest.mark.parametrize("q_lora_rank", [0, 24])
def test_mla_apply_matches_reference(q_lora_rank):
    """One MLA layer over a full sequence (the kernel's path: q.k 24, v
    16 on the CPU) within 1e-5, with the full-rank query and with the
    ``wq_a`` / ``q_a_norm`` / ``wq_b`` branch."""
    jcfg, tcfg = _mla_cfgs(q_lora_rank=q_lora_rank)
    params, model = _carried(jcfg, tcfg, seed=q_lora_rank)
    jp, tp = _layer0(params, model)
    assert (tp.wq is None) == bool(q_lora_rank)
    assert (tp.wq_b is not None) == bool(q_lora_rank)
    x = np.random.default_rng(1).standard_normal((2, 40, jcfg.d_model),
                                                  dtype=np.float32)
    want, _ = jax_attention.mla_apply(jp, jnp.asarray(x), jcfg)
    got, cache = attention.mla_apply(tp, torch.from_numpy(x), tcfg)
    assert cache is None
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)


def _mla_cache(cfg, b, max_len):
    """One layer's cache: the stacked spec's first entry."""
    return {n: c[0] for n, c in zoo.init_cache(cfg, b, max_len,
                                               device="cpu")["layers"].items()}


def _jax_mla_cache(cfg, b, max_len):
    return jax.tree.map(lambda a: a[0],
                        jax_zoo.init_cache(cfg, b, max_len)["layers"])


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_mla_prefill_then_absorbed_decode_matches_reference(quant):
    """A prefill of 24 positions into the latent cache, then 4 absorbed
    decode steps, against the reference's within 1e-4; the cache's rows
    too (the int8 codes exactly, their scales and the rope keys within
    1e-4)."""
    jcfg, tcfg = _mla_cfgs(q_lora_rank=0)
    jcfg = dataclasses.replace(jcfg, kv_cache_quant=quant)
    tcfg = dataclasses.replace(tcfg, kv_cache_quant=quant)
    params, model = _carried(jcfg, tcfg, seed=2)
    jp, tp = _layer0(params, model)
    B, S, max_len = 2, 24, 32
    x = np.random.default_rng(2).standard_normal((B, S + 4, jcfg.d_model),
                                                  dtype=np.float32)
    jc, tc = _jax_mla_cache(jcfg, B, max_len), _mla_cache(tcfg, B, max_len)
    assert set(tc) == set(jc)
    for step in range(5):
        lo, n = (0, S) if step == 0 else (S + step - 1, 1)
        xs = x[:, lo:lo + n]
        want, jc = jax_attention.mla_apply(
            jp, jnp.asarray(xs), jcfg, kv_cache=jc,
            cache_index=jnp.int32(lo), cache_len=jnp.int32(lo + n))
        got, tc = attention.mla_apply(tp, torch.from_numpy(xs), tcfg,
                                      kv_cache=tc, cache_index=lo,
                                      cache_len=lo + n)
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-4,
                                   err_msg=f"step {step}")
    for n in tc:
        if tc[n].dtype == torch.int8:
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
        else:
            np.testing.assert_allclose(np32(tc[n]), np32(jc[n]), atol=1e-4,
                                       err_msg=n)


def test_absorbed_decode_equals_the_longer_materialised_prefill():
    """prefill(S) + one absorbed decode step equals prefill(S + 1) (K and
    V materialised from the latent) within 1e-4, in both packages."""
    jcfg, tcfg = _mla_cfgs(q_lora_rank=0)
    params, model = _carried(jcfg, tcfg, seed=3)
    jp, tp = _layer0(params, model)
    B, S = 2, 20
    x = np.random.default_rng(3).standard_normal((B, S + 1, jcfg.d_model),
                                                  dtype=np.float32)
    jc = _jax_mla_cache(jcfg, B, S + 4)
    _, jc = jax_attention.mla_apply(jp, jnp.asarray(x[:, :S]), jcfg,
                                    kv_cache=jc, cache_index=jnp.int32(0),
                                    cache_len=jnp.int32(S))
    j_step, _ = jax_attention.mla_apply(jp, jnp.asarray(x[:, S:]), jcfg,
                                        kv_cache=jc,
                                        cache_index=jnp.int32(S),
                                        cache_len=jnp.int32(S + 1))
    j_whole, _ = jax_attention.mla_apply(
        jp, jnp.asarray(x), jcfg, kv_cache=_jax_mla_cache(jcfg, B, S + 4),
        cache_index=jnp.int32(0), cache_len=jnp.int32(S + 1))
    np.testing.assert_allclose(np32(j_step[:, 0]), np32(j_whole[:, -1]),
                               atol=1e-4)
    tc = _mla_cache(tcfg, B, S + 4)
    attention.mla_apply(tp, torch.from_numpy(x[:, :S]), tcfg, kv_cache=tc,
                        cache_index=0, cache_len=S)
    t_step, _ = attention.mla_apply(tp, torch.from_numpy(x[:, S:]), tcfg,
                                    kv_cache=tc, cache_index=S,
                                    cache_len=S + 1)
    t_whole, _ = attention.mla_apply(tp, torch.from_numpy(x), tcfg,
                                     kv_cache=_mla_cache(tcfg, B, S + 4),
                                     cache_index=0, cache_len=S + 1)
    np.testing.assert_allclose(np32(t_step[:, 0]), np32(t_whole[:, -1]),
                               atol=1e-4)
    np.testing.assert_allclose(np32(t_step), np32(j_step), atol=1e-4)


# ------------------------------------------------------------ int8 cache
def test_kv_quant_codes_and_scales_match_reference():
    """``_kv_quant`` on rows of several scales: the bf16 scales equal the
    reference's, and the int8 codes equal them except where x / scale lies
    within f32 error of .5 (both round half to even; the two frameworks'
    divides may differ in the last bit there): such rows are counted, at
    most 1e-3 of the codes, each one code apart."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 64, 3, 128)) *
         rng.uniform(1e-3, 30, (4, 64, 3, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-6 floor
    jq, js = jax_attention._kv_quant(jnp.asarray(x))
    tq, ts = attention._kv_quant(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(ts), np32(js))
    jq = np.asarray(jq, np.int32)
    tq = tq.numpy().astype(np.int32)
    diff = tq != jq
    scale = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-6) / np.float32(
        127.0)
    ratio = (x / scale).astype(np.float64)
    near_half = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-5
    assert not (diff & ~near_half).any()
    assert diff.sum() <= 1e-3 * diff.size
    assert (np.abs(tq - jq) <= 1).all()
    deq = attention._kv_dequant(torch.from_numpy(jq.astype(np.int8)),
                                torch.from_numpy(np32(js)).bfloat16(),
                                "float32")
    want = jax_attention._kv_dequant(jnp.asarray(jq, jnp.int8), js,
                                     jnp.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", [SMOLLM, DEEPSEEK])
def test_int8_cache_decode_matches_reference(arch):
    """A whole reduced model on the int8 cache (GQA's k and v, or MLA's
    latent): the cache layout equals the reference's, and a prefill of 24
    positions and 3 decode steps give logits within 1e-4 of the
    reference's, the int8 rows exactly equal."""
    jcfg, tcfg = _reduced(arch, kv_cache_quant=True)
    params, model = _carried(jcfg, tcfg, seed=5)
    B, S, max_len = 2, 24, 32
    t = _tokens(jcfg, B, S, seed=5)
    nxt = _tokens(jcfg, 3 * B, 1, seed=6).reshape(3, B, 1)
    jc = jax_zoo.init_cache(jcfg, B, max_len)
    tc = zoo.init_cache(tcfg, B, max_len, device="cpu")
    assert set(tc) == set(jc)
    for key in tc:
        assert {n: (tuple(c.shape), str(c.dtype).split(".")[-1])
                for n, c in tc[key].items()} == \
            {n: (tuple(c.shape), str(c.dtype)) for n, c in jc[key].items()}
    with GateGaps() as gaps:
        for step in range(4):
            idx = 0 if step == 0 else S + step - 1
            tb = t if step == 0 else nxt[step - 1]
            want, jc = jax_zoo.decode_step(
                params, jcfg, {"tokens": jnp.asarray(tb, jnp.int32)}, jc,
                cache_index=jnp.int32(idx))
            got, tc = zoo.decode_step(model, tcfg,
                                      {"tokens": torch.from_numpy(tb)}, tc,
                                      cache_index=idx)
            np.testing.assert_allclose(np32(got), np32(want), atol=1e-4,
                                       err_msg=f"step {step}")
    if arch == DEEPSEEK:
        gaps.check()
    for key in tc:
        for n, c in tc[key].items():
            if c.dtype == torch.int8:
                np.testing.assert_array_equal(c.numpy(),
                                              np.asarray(jc[key][n]))


# ------------------------------------------------------------ whole model
@pytest.fixture(scope="module")
def deepseek():
    jcfg, tcfg = _reduced(DEEPSEEK)
    params, model = _carried(jcfg, tcfg)
    return jcfg, tcfg, params, model


def test_model_layout_has_mla_everywhere(deepseek):
    """DeepSeek's leading dense layer and its MoE layers all take MLA;
    the decode cache holds the latent and the rope key, as the
    reference's."""
    jcfg, tcfg, params, model = deepseek
    for layer in [*model.dense_layers, *model.layers]:
        assert isinstance(layer.attn, attention.MLAAttention)
        assert tuple(layer.attn.wkv_b.w.shape) == (
            tcfg.mla.kv_lora_rank,
            tcfg.n_heads * (tcfg.mla.qk_nope_head_dim + tcfg.mla.v_head_dim))
    caches = zoo.init_cache(tcfg, 2, 16, device="cpu")
    jcaches = jax_zoo.init_cache(jcfg, 2, 16)
    assert set(caches) == set(jcaches) == {"dense_layers", "layers"}
    for key in caches:
        assert set(caches[key]) == {"c_kv", "k_rope"}
        for n in caches[key]:
            assert tuple(caches[key][n].shape) == jcaches[key][n].shape


def test_prefill_then_decode_matches_reference(deepseek):
    jcfg, tcfg, params, model = deepseek
    B, S, max_len = 2, 24, 32
    t = _tokens(jcfg, B, S, seed=1)
    nxt = _tokens(jcfg, 4 * B, 1, seed=2).reshape(4, B, 1)
    jc = jax_zoo.init_cache(jcfg, B, max_len)
    tc = zoo.init_cache(tcfg, B, max_len, device="cpu")
    with GateGaps() as gaps:
        for step in range(5):
            idx = 0 if step == 0 else S + step - 1
            tb = t if step == 0 else nxt[step - 1]
            want, jc = jax_zoo.decode_step(
                params, jcfg, {"tokens": jnp.asarray(tb, jnp.int32)}, jc,
                cache_index=jnp.int32(idx))
            got, tc = zoo.decode_step(model, tcfg,
                                      {"tokens": torch.from_numpy(tb)}, tc,
                                      cache_index=idx)
            np.testing.assert_allclose(np32(got), np32(want), atol=1e-4,
                                       err_msg=f"step {step}")
    gaps.check()
    for key in tc:
        for n in tc[key]:
            np.testing.assert_allclose(np32(tc[key][n]), np32(jc[key][n]),
                                       atol=1e-4)


def test_greedy_generate_matches_reference(deepseek):
    """``greedy_generate`` of 3 prompts, 12 new tokens: the prefill's and
    every step's logits within 1e-3 of the reference's (each framework
    fed the reference's tokens), and at least 99 % of the tokens
    equal."""
    from repro.serve.serve_step import greedy_generate as jax_greedy

    jcfg, tcfg, params, model = deepseek
    prompt = _tokens(jcfg, 3, 17, seed=3)
    with GateGaps() as gaps:
        got = greedy_generate(model, tcfg, prompt, max_new=12, device="cpu")
    gaps.check()
    want = np.asarray(jax_greedy(params, jcfg, jnp.asarray(prompt, jnp.int32),
                                 max_new=12))
    assert float((got.numpy() == want).mean()) >= 0.99
    jc = jax_zoo.init_cache(jcfg, 3, 17 + 12)
    tc = zoo.init_cache(tcfg, 3, 17 + 12, device="cpu")
    toks = np.concatenate([prompt, want[:, :-1]], axis=1)
    for step in range(12):
        idx = 0 if step == 0 else 16 + step
        tb = toks[:, :17] if step == 0 else toks[:, idx:idx + 1]
        jl, jc = jax_zoo.decode_step(params, jcfg,
                                     {"tokens": jnp.asarray(tb, jnp.int32)},
                                     jc, cache_index=jnp.int32(idx))
        tl, tc = zoo.decode_step(model, tcfg, {"tokens": torch.from_numpy(tb)},
                                 tc, cache_index=idx)
        np.testing.assert_allclose(np32(tl), np32(jl), atol=1e-3)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_continuous_batcher_drains_as_the_reference(deepseek, quant):
    """Wave admission on the latent cache, float and int8: the port's
    batcher drains as the reference's, with at least 99 % of the tokens
    equal."""
    jcfg, tcfg, params, model = deepseek
    jcfg = dataclasses.replace(jcfg, kv_cache_quant=quant)
    tcfg = dataclasses.replace(tcfg, kv_cache_quant=quant)
    jb = JaxBatcher(jcfg, params, slots=3, max_len=64)
    tb = ContinuousBatcher(tcfg, model, slots=3, max_len=64, device="cpu")
    for batcher in (jb, tb):
        rng = np.random.default_rng(4)
        for _ in range(6):
            batcher.submit(rng.integers(0, jcfg.vocab, int(rng.integers(6, 20)))
                           .astype(np.int32), max_new=int(rng.integers(4, 12)))
    with GateGaps() as gaps:
        ts = tb.run_until_drained()
    gaps.check()
    js = jb.run_until_drained()
    for k in ("requests", "ticks", "tokens"):
        assert ts[k] == js[k], k
    assert ts["requests"] == 6
    got = {r.rid: r.out_tokens for r in tb.finished}
    want = {r.rid: r.out_tokens for r in jb.finished}
    same = sum(a == b for rid in want for a, b in zip(got[rid], want[rid]))
    assert same >= 0.99 * sum(len(t) for t in want.values())


def _unstack(tree, tcfg):
    """The reference's stacked tree as {port state_dict name: array}."""
    n_dense = tcfg.moe.first_dense_layers
    stacks = {"layers": tcfg.n_layers - n_dense, "dense_layers": n_dense}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(p.key) for p in path)
        arr = np.asarray(leaf, np.float32)
        stack, _, rest = name.partition("/")
        if stack in stacks:
            for i in range(stacks[stack]):
                out[f"{stack}.{i}.{rest.replace('/', '.')}"] = arr[i]
        else:
            out[name.replace("/", ".")] = arr
    return out


def test_loss_and_gradients_match_reference(deepseek):
    """``loss_fn`` within rtol 1e-5 of ``zoo.loss_fn``, and every gradient
    leaf (the MLA projections' through the plain attention backward at
    q.k 24, v 16) within 1e-4 of its largest value against
    ``jax.grad``."""
    jcfg, tcfg, params, model = deepseek
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 25),
                                             dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss = jax_zoo.loss_fn(params, jcfg, jb)[0]
    want = _unstack(jax.grad(lambda p: jax_zoo.loss_fn(p, jcfg, jb)[0])(
        params), tcfg)
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        with GateGaps() as gaps:
            loss, _ = zoo.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(named.values()))
    finally:
        model.requires_grad_(False)
    gaps.check()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = dict(zip(named, grads))
    assert set(got) == set(want)
    assert any(".attn.wkv_b." in n for n in got)
    for name, g in got.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np32(g), w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


# ------------------------------------------------------------ full width
def test_full_width_param_count_equals_reference():
    """On ``meta``: 27 layers (one dense at d_ff 10944), MLA at rank 512,
    q.k 128 + 64 and v 128, 64 routed experts and 2 shared:
    15,706,484,224 parameters, the reference's ``analytic_param_count``
    (2,661,150,208 active)."""
    jcfg, tcfg = jax_get_config(DEEPSEEK), get_config(DEEPSEEK)
    model = zoo.Model(tcfg, device="meta")
    assert len(model.dense_layers) == 1 and len(model.layers) == 26
    attn = model.layers[0].attn
    assert tuple(attn.wq.w.shape) == (2048, 16 * 192)
    assert tuple(attn.wkv_a.w.shape) == (2048, 512 + 64)
    assert tuple(attn.wkv_b.w.shape) == (512, 16 * (128 + 128))
    assert tuple(attn.wo.w.shape) == (16 * 128, 2048)
    total = sum(p.numel() for p in model.parameters())
    assert total == zoo.analytic_param_count(tcfg) == \
        jax_zoo.analytic_param_count(jcfg) == 15_706_484_224
    assert zoo.analytic_param_count(tcfg, active_only=True) == \
        jax_zoo.analytic_param_count(jcfg, active_only=True) == 2_661_150_208
