"""The port's model side (``repro_torch.configs``, ``repro_torch.models``)
against the JAX reference: layers, GQA attention (full, prefill then
decode, ``kv_repeat``), the forward pass and ``decode_step`` of a narrow
smollm-family model whose weights are the reference's, carried across by
``params_from_numpy``.  Inputs are made with numpy from a seed.

Tolerances: f32 at atol 1e-4 (the point is the algorithm: both packages
compute in f32 and differ only in summation order); bf16 at the
reference's own bf16 tolerance for a prefill against a forward
(``tests/test_models_smoke.py``: atol 0.15, rtol 0.05), since XLA and torch
round bf16 products at different places."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import zoo as jax_zoo
from repro_torch.configs.base import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs.base import get_config as port_get_config
from repro_torch.models import attention, layers, zoo
from repro_torch.models.convert import params_from_numpy

ATOL_F32 = 1e-4
BF16 = dict(atol=0.15, rtol=0.05)
NARROW = dict(n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
              d_ff=512, vocab=512, q_chunk=16, kv_chunk=16)


def both(arch="smollm-135m", **kw):
    """The reference's and the port's config of ``arch`` with ``kw``."""
    return (dataclasses.replace(get_config(arch), **kw),
            dataclasses.replace(port_get_config(arch), **kw))


def f32(**kw):
    """The narrow config, in f32 unless ``kw`` says otherwise."""
    return both(**{**NARROW, "param_dtype": "float32",
                   "compute_dtype": "float32", **kw})


def carried(jcfg, tcfg, seed=0):
    params = jax_zoo.init_model(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_numpy(tcfg, tree, device="cpu"), tree


def tokens(cfg, b, s, seed=0):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_copies_match(arch):
    assert PORT_ARCH_IDS == ARCH_IDS
    assert (dataclasses.asdict(port_get_config(arch))
            == dataclasses.asdict(get_config(arch)))


def test_param_count_of_smollm_135m():
    cfg = port_get_config("smollm-135m")
    assert cfg.param_count() == 134_515_008
    assert cfg.param_count() == get_config("smollm-135m").param_count()
    assert cfg.active_param_count() == 134_515_008


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b"])
def test_encdec_and_vlm_build_on_meta(arch):
    """The encoder-decoder and VLM families build with the reference's
    parameter count."""
    model = zoo.Model(port_get_config(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        get_config(arch).param_count()


def test_unknown_family_raises():
    cfg = dataclasses.replace(port_get_config("smollm-135m"), family="speech")
    with pytest.raises(ValueError, match="unknown family"):
        zoo.init_model(cfg, 0, device="cpu")


def test_mla_family_builds_on_meta():
    """deepseek-v2-lite-16b (MoE with MLA) builds: every layer's attention
    is MLA, with the reference's leaves."""
    cfg = port_get_config("deepseek-v2-lite-16b")
    model = zoo.Model(cfg, device="meta")
    assert len(model.dense_layers) == 1 and len(model.layers) == 26
    for layer in (model.dense_layers[0], model.layers[0]):
        assert isinstance(layer.attn, attention.MLAAttention)
        assert {n for n, _ in layer.attn.named_parameters()} == {
            "wq.w", "wkv_a.w", "kv_a_norm.scale", "wkv_b.w", "wo.w"}
    assert cfg.param_count() == get_config(
        "deepseek-v2-lite-16b").param_count()


def test_moe_family_builds_on_meta():
    cfg = port_get_config("qwen3-moe-30b-a3b")
    model = zoo.Model(cfg, device="meta")
    assert len(model.layers) == 48 and model.dense_layers is None
    assert tuple(model.layers[0].moe.w_gate.shape) == (128, 2048, 768)
    assert cfg.param_count() == get_config("qwen3-moe-30b-a3b").param_count()


@pytest.mark.parametrize("kw", [dict(kv_cache_shard="rows")])
def test_unported_cache_layouts_raise(kw):
    _, tcfg = f32(**kw)
    with pytest.raises(ValueError, match="the placements are"):
        zoo.init_model(tcfg, 0, device="cpu")


@pytest.mark.parametrize("quant", [False, True])
def test_sequence_placed_cache_decodes_alike_on_one_device(quant):
    """``kv_cache_shard="seq"`` places the cache over a mesh; on one
    device it is the same cache, and the decode the same, bit for bit."""
    _, heads = f32(kv_cache_quant=quant)
    seq = dataclasses.replace(heads, kv_cache_shard="seq")
    model = zoo.init_model(heads, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, heads.vocab, (2, 6)))
    out = []
    for cfg in (heads, seq):
        caches = zoo.init_cache(cfg, 2, 10, device="cpu")
        with torch.no_grad():
            lg, caches = zoo.decode_step(model, cfg, {"tokens": toks},
                                         caches, cache_index=0)
            lg2, _ = zoo.decode_step(model, cfg, {"tokens": toks[:, :1]},
                                     caches, cache_index=6)
        out.append((lg, lg2))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b"])
def test_int8_cache_layouts_match_reference(arch):
    """``kv_cache_quant``: the decode cache's names, shapes and dtypes
    equal the reference's (int8 k and v with bf16 scales for GQA and the
    hybrid's shared block, an int8 latent with a bf16 scale for MLA)."""
    from repro.configs.base import reduce_config as jax_reduce
    from repro_torch.configs.base import reduce_config

    jcfg = dataclasses.replace(jax_reduce(get_config(arch)),
                               kv_cache_quant=True)
    tcfg = dataclasses.replace(reduce_config(port_get_config(arch)),
                               kv_cache_quant=True)
    specs = zoo.init_cache_specs(tcfg, 2, 16)
    jspecs = jax_zoo.init_cache_specs(jcfg, 2, 16)
    assert set(specs) == set(jspecs)
    for key in specs:
        assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for n, t in specs[key].items()} == \
            {n: (tuple(t.shape), str(t.dtype)) for n, t in jspecs[key].items()}
        assert any(t.dtype == torch.int8 for t in specs[key].values()) \
            or key == "layers" and tcfg.family == "hybrid"


# ------------------------------------------------------------------ layers
def test_layers_match_reference():
    jcfg, tcfg = f32()
    params, model, _ = carried(jcfg, tcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 192), dtype=np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jl = jax.tree.map(lambda a: a[0], params["layers"])
    tl = model.layers[0]
    pairs = [
        (jax_layers.dense_apply(jl["attn"]["wq"], jx, "float32"),
         layers.dense_apply(tl.attn.wq, tx, "float32")),
        (jax_layers.mlp_apply(jl["mlp"], jx, "float32"),
         layers.mlp_apply(tl.mlp, tx, "float32")),
        (jax_layers.embedding_apply(params["embed"], jnp.asarray([[3, 7]]),
                                    "float32"),
         layers.embedding_apply(model.embed, torch.tensor([[3, 7]]),
                                "float32")),
    ]
    scale = rng.standard_normal(192).astype(np.float32)
    bias = rng.standard_normal(192).astype(np.float32)
    for kind in ("rmsnorm", "layernorm", "layernorm_nonparam"):
        norm = layers.Norm(kind, 192)
        jp = {}
        if norm.scale is not None:
            norm.scale.data = torch.from_numpy(scale)
            jp["scale"] = jnp.asarray(scale)
        if norm.bias is not None:
            norm.bias.data = torch.from_numpy(bias)
            jp["bias"] = jnp.asarray(bias)
        pairs.append((jax_layers.norm_apply(kind, jp, jx * 3 + 1),
                      layers.norm_apply(kind, norm, tx * 3 + 1)))
    h = rng.standard_normal((2, 5, 3, 32), dtype=np.float32)
    pos = np.arange(4, 9)
    pairs.append((jax_layers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e4),
                  layers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                                    1e4)))
    for want, got in pairs:
        np.testing.assert_allclose(np32(got), np32(want), atol=ATOL_F32)


def test_rope_is_split_half_and_keeps_dtype():
    x = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    x[..., 0] = 1.0  # first half, pair (0, 4)
    out = layers.apply_rope(x, torch.tensor([1]), 1e4)
    assert out.dtype == torch.bfloat16
    assert out[..., 4].item() != 0 and out[..., 1].item() == 0


# ------------------------------------------------------------------ attention
def _attn_both(jcfg, tcfg, seed=0):
    params, model, _ = carried(jcfg, tcfg, seed)
    return (jax.tree.map(lambda a: a[0], params["layers"]["attn"]),
            model.layers[0].attn)


def test_attention_full_matches_reference():
    jcfg, tcfg = f32()
    jp, tp = _attn_both(jcfg, tcfg)
    x = np.random.default_rng(2).standard_normal((2, 40, 192),
                                                 dtype=np.float32)
    for causal in (True, False):
        want, _ = jax_attention.attention_apply(jp, jnp.asarray(x), jcfg,
                                                causal=causal)
        got, _ = attention.attention_apply(tp, torch.from_numpy(x), tcfg,
                                           causal=causal)
        np.testing.assert_allclose(np32(got), np32(want), atol=ATOL_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_prefill_then_decode(dtype):
    """Prefill S tokens into a cache, decode one more: as the reference's
    ``tests/test_attention.py``, the decode output matches the full pass at
    position S, and both packages agree on the output and the cache."""
    jcfg, tcfg = f32(compute_dtype=dtype)
    jp, tp = _attn_both(jcfg, tcfg)
    B, S = 2, 16
    x = np.random.default_rng(3).standard_normal((B, S + 1, 192),
                                                 dtype=np.float32)
    full, _ = attention.attention_apply(tp, torch.from_numpy(x), tcfg)
    shape = (B, S + 1, tcfg.n_kv_heads, tcfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=getattr(torch, dtype)),
             "v": torch.zeros(shape, dtype=getattr(torch, dtype))}
    pre, same = attention.attention_apply(
        tp, torch.from_numpy(x[:, :S]), tcfg, kv_cache=cache, cache_index=0,
        cache_len=S)
    assert same is cache  # updated in place
    out1, _ = attention.attention_apply(
        tp, torch.from_numpy(x[:, S:]), tcfg, causal=False, kv_cache=cache,
        cache_index=S, cache_len=S + 1)
    tol = dict(atol=ATOL_F32) if dtype == "float32" else dict(atol=3e-2)
    np.testing.assert_allclose(np32(out1), np32(full[:, S:]), **tol)
    np.testing.assert_allclose(np32(pre), np32(full[:, :S]), **tol)

    jcache = {k: jnp.zeros(shape, dtype) for k in ("k", "v")}
    jpre, jcache = jax_attention.attention_apply(
        jp, jnp.asarray(x[:, :S]), jcfg, causal=True, kv_cache=jcache,
        cache_index=jnp.int32(0), cache_len=jnp.int32(S))
    jout1, jcache = jax_attention.attention_apply(
        jp, jnp.asarray(x[:, S:]), jcfg, causal=False, kv_cache=jcache,
        cache_index=jnp.int32(S), cache_len=jnp.int32(S + 1))
    tol = dict(atol=ATOL_F32) if dtype == "float32" else BF16
    for want, got in ((jpre, pre), (jout1, out1), (jcache["k"], cache["k"]),
                      (jcache["v"], cache["v"])):
        np.testing.assert_allclose(np32(got), np32(want), **tol)


def test_prefill_at_nonzero_index_raises():
    _, tcfg = f32()
    tp = zoo.init_model(tcfg, 0, device="cpu").layers[0].attn
    cache = {k: torch.zeros(1, 8, 2, 32) for k in ("k", "v")}
    with pytest.raises(NotImplementedError):
        attention.attention_apply(tp, torch.zeros(1, 3, 192), tcfg,
                                  kv_cache=cache, cache_index=2, cache_len=5)


def test_kv_repeat_matches_reference_and_base():
    jcfg, tcfg = f32(n_heads=8)
    jp, tp = _attn_both(jcfg, tcfg)
    x = np.random.default_rng(4).standard_normal((2, 24, 192),
                                                 dtype=np.float32)
    base, _ = attention.attention_apply(tp, torch.from_numpy(x), tcfg)
    jcfg2 = dataclasses.replace(jcfg, kv_repeat=2)
    tcfg2 = dataclasses.replace(tcfg, kv_repeat=2)
    rep, _ = attention.attention_apply(tp, torch.from_numpy(x), tcfg2)
    want, _ = jax_attention.attention_apply(jp, jnp.asarray(x), jcfg2)
    np.testing.assert_allclose(np32(rep), np32(base), atol=ATOL_F32)
    np.testing.assert_allclose(np32(rep), np32(want), atol=ATOL_F32)


@pytest.mark.parametrize("impl", ["chunked", "chunked_noskip", "naive"])
def test_grouped_attention_impls_agree(impl):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 33, 2, 3, 16), dtype=np.float32)
    k = rng.standard_normal((2, 33, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 33, 2, 16), dtype=np.float32)
    jpos, tpos = jnp.arange(33), torch.arange(33)
    for causal in (True, False):
        want = jax_attention.grouped_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            q_pos=jpos, kv_pos=jpos, impl="naive")
        got = attention.grouped_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, q_pos=tpos, kv_pos=tpos, impl=impl, q_chunk=8,
            kv_chunk=8)
        np.testing.assert_allclose(np32(got), np32(want), atol=ATOL_F32)


# ------------------------------------------------------------------ model
def test_forward_matches_reference():
    jcfg, tcfg = f32()
    params, model, _ = carried(jcfg, tcfg)
    jt, tt = tokens(jcfg, 2, 40)
    want = jax_zoo.forward(params, jcfg, {"tokens": jt}, remat=False)
    got = zoo.forward(model, tcfg, {"tokens": tt})
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """A prefill of 40 tokens (S not a multiple of the chunks) and three
    decode steps, on the reference's weights."""
    jcfg, tcfg = f32(compute_dtype=dtype)
    params, model, _ = carried(jcfg, tcfg)
    B, S, max_len = 2, 40, 48
    jt, tt = tokens(jcfg, B, S, seed=1)
    jc = jax_zoo.init_cache(jcfg, B, max_len)
    tc = zoo.init_cache(tcfg, B, max_len, device="cpu")
    tol = dict(atol=ATOL_F32) if dtype == "float32" else BF16
    nxt = np.random.default_rng(2).integers(0, jcfg.vocab, (3, B, 1))
    for step in range(4):
        idx = 0 if step == 0 else S + step - 1
        jb = jt if step == 0 else jnp.asarray(nxt[step - 1], jnp.int32)
        tb = tt if step == 0 else torch.from_numpy(nxt[step - 1])
        want, jc = jax_zoo.decode_step(params, jcfg, {"tokens": jb}, jc,
                                       cache_index=jnp.int32(idx))
        got, tc = zoo.decode_step(model, tcfg, {"tokens": tb}, tc,
                                  cache_index=idx)
        assert got.shape == (B, 1, tcfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(np32(got), np32(want), **tol)
    np.testing.assert_allclose(np32(tc["layers"]["k"]),
                               np32(jc["layers"]["k"]), **tol)


def test_prefill_matches_forward_last_position():
    jcfg, tcfg = f32()
    _, model, _ = carried(jcfg, tcfg)
    _, tt = tokens(jcfg, 2, 32)
    h = zoo.forward(model, tcfg, {"tokens": tt})
    want = zoo.logits_fn(model, tcfg, h[:, -1:])
    got, _ = zoo.decode_step(model, tcfg, {"tokens": tt},
                             zoo.init_cache(tcfg, 2, 32, device="cpu"),
                             cache_index=0)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL_F32)


def test_init_model_shapes_and_seed():
    _, tcfg = f32()
    a = zoo.init_model(tcfg, 3, device="cpu")
    b = zoo.init_model(tcfg, torch.Generator().manual_seed(3), device="cpu")
    jshapes = jax.eval_shape(lambda: jax_zoo.init_model(
        dataclasses.replace(get_config("smollm-135m"), **NARROW),
        jax.random.key(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]:
        name = "/".join(str(p.key) for p in path)
        if name.startswith("layers/"):
            for i in range(tcfg.n_layers):
                want[f"layers.{i}." + name[7:].replace("/", ".")] = \
                    tuple(leaf.shape[1:])
        else:
            want[name.replace("/", ".")] = tuple(leaf.shape)
    got = {n: tuple(t.shape) for n, t in a.state_dict().items()}
    assert got == want
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    # the reference's scales: embeddings 0.02, projections 1/sqrt(d_in)
    assert abs(float(a.embed.table.std()) - 0.02) < 2e-3
    assert abs(float(a.layers[0].mlp.down.w.std()) - 512 ** -0.5) < 5e-3


# ------------------------------------------------------------------ convert
def test_params_from_numpy_carries_values_exactly():
    jcfg, tcfg = both(**NARROW)
    params, model, tree = carried(jcfg, tcfg)
    assert model.embed.table.dtype == torch.float32  # param_dtype float32
    np.testing.assert_array_equal(model.embed.table.numpy(),
                                  tree["embed"]["table"])
    # bf16 params stay bf16, bit for bit
    jcfg, tcfg = both(**NARROW, param_dtype="bfloat16")
    params, model, tree = carried(jcfg, tcfg)
    assert model.layers[1].attn.wk.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.layers[1].attn.wk.w.float().numpy(),
        np.asarray(tree["layers"]["attn"]["wk"]["w"][1], np.float32))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "unstacked"])
def test_params_from_numpy_rejects_wrong_tree(fault):
    jcfg, tcfg = f32()
    tree = jax.tree.map(np.asarray,
                        jax_zoo.init_model(jcfg, jax.random.key(0)))
    if fault == "missing":
        del tree["layers"]["mlp"]["up"]
    elif fault == "extra":
        tree["lm_head"] = {"w": np.zeros((192, 512), np.float32)}
    elif fault == "shape":
        tree["final_norm"]["scale"] = np.ones(191, np.float32)
    else:
        tree["layers"]["ln1"]["scale"] = np.ones((3, 192), np.float32)
    with pytest.raises(ValueError):
        params_from_numpy(tcfg, tree, device="cpu")
