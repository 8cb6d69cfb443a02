"""olmo-1b, qwen2-72b and yi-34b on the port against the JAX reference, on
the CPU: each architecture at ``reduce_config`` with its query heads widened
so the published group survives (olmo 4 on 4 KV heads, qwen2 8 on 1, yi 7
on 1), the reference's weights carried across with ``params_from_numpy``
(qwen2's QKV biases drawn nonzero first, in both trees), and inputs made
with numpy from a seed.

What is new in these three against the dense model the other tests hold
(smollm-135m): olmo's non-parametric LayerNorm, which has no leaf in
either tree; qwen2's QKV biases; query groups of 1, 7 and 8; RoPE at
theta 1e4, 1e6 and 5e6.

Tolerances (f32: the two packages differ only in summation order): prefill
and decode logits within 1e-4, greedy tokens equal, the loss at rtol 1e-5,
each gradient leaf within 1e-4 of its largest |value| (the training
oracle, ``jax.grad`` of the reference's ``loss_fn``); RoPE within 1e-5 on
unit inputs at positions up to 4,095, their inverse frequencies
equal bit for bit.  The full-width parameter counts
are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import layers as jax_layers
from repro.models import zoo as jax_zoo
from repro.serve.serve_step import greedy_generate as jax_greedy_generate
from repro.serve.serve_step import make_decode_step as jax_make_decode_step
from repro.serve.serve_step import make_prefill_step as jax_make_prefill_step
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import layers, params_from_numpy, zoo
from repro_torch.models.convert import _flatten
from repro_torch.serve import (greedy_generate, make_decode_step,
                               make_prefill_step)

#: (query heads, KV heads) of the reduced configs: the published groups
ARCHS = {"olmo-1b": (4, 4), "qwen2-72b": (8, 1), "yi-34b": (7, 1)}
HEAD_DIM = 16
F32 = dict(param_dtype="float32", compute_dtype="float32")
#: published parameter counts at full width and depth (and qwen2-72b at
#: the 32 layers one H100 serves)
PUBLISHED = {"olmo-1b": 1_279_787_008, "qwen2-72b": 72_706_203_648,
             "yi-34b": 34_388_917_248}
QWEN2_32_LAYERS = 30_577_336_320
ATOL = 1e-4
B, S, NEW = 2, 24, 5


def _configs(arch):
    h, kv = ARCHS[arch]
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=HEAD_DIM, **F32)
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                                **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


def _with_biases(tree, rng):
    """``tree`` with every bias leaf (``.../b``) drawn from ``rng``: the
    reference initialises them to 0, which would hide their path."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape, dtype=np.float32) * 0.5
                    if k == "b" else _with_biases(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """(arch, jax cfg, jax params, port cfg, port model, numpy tree) from
    the same weights."""
    arch = request.param
    jcfg, tcfg = _configs(arch)
    tree = jax.tree.map(np.asarray, jax_zoo.init_model(jcfg,
                                                       jax.random.key(3)))
    tree = _with_biases(tree, np.random.default_rng(4))
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(tcfg, tree, device="cpu")
    return arch, jcfg, params, tcfg, model, tree


def _prompts(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def test_widened_configs_keep_the_published_groups(pair):
    arch, jcfg, _, tcfg, model, _ = pair
    full = get_config(arch)
    assert (tcfg.n_heads // tcfg.n_kv_heads
            == full.n_heads // full.n_kv_heads == jcfg.n_heads
            // jcfg.n_kv_heads)
    assert (tcfg.norm, tcfg.qkv_bias, tcfg.rope_theta) == (
        full.norm, full.qkv_bias, full.rope_theta)
    attn = model.layers[0].attn
    assert tuple(attn.wq.w.shape) == (tcfg.d_model,
                                      tcfg.n_heads * HEAD_DIM)
    assert tuple(attn.wk.w.shape) == (tcfg.d_model,
                                      tcfg.n_kv_heads * HEAD_DIM)


def test_leaves_carried_across(pair):
    """Both trees hold the same leaves with the same values: olmo's
    non-parametric LayerNorm has none (no scale, no bias) in either, and
    qwen2's QKV biases are carried exactly; no other architecture here
    has a bias."""
    arch, _, _, tcfg, model, tree = pair
    ref = {n.replace("/", "."): np.asarray(a)
           for n, a in _flatten(tree).items()}
    port = {n: t.numpy() for n, t in model.state_dict().items()}
    stacked = {n for n in ref if n.startswith("layers.")}
    assert {f"layers.{i}.{n[len('layers.'):]}" for n in stacked
            for i in range(tcfg.n_layers)} | (set(ref) - stacked) == set(port)
    for n in stacked:
        for i in range(tcfg.n_layers):
            np.testing.assert_array_equal(
                port[f"layers.{i}.{n[len('layers.'):]}"], ref[n][i])
    norms = [n for n in port if n.rsplit(".", 1)[-1] in ("scale", "bias")]
    biases = sorted(n for n in port if n.endswith(".b"))
    if arch == "olmo-1b":
        assert norms == [] and not any("ln" in n or "norm" in n
                                       for n in ref)
        assert model.final_norm.scale is None
    else:
        assert norms
    if arch == "qwen2-72b":
        assert biases == sorted(f"layers.{i}.attn.{w}.b"
                                for i in range(tcfg.n_layers)
                                for w in ("wq", "wk", "wv"))
        attn = model.layers[1].attn
        assert tuple(attn.wq.b.shape) == (tcfg.n_heads * HEAD_DIM,)
        assert tuple(attn.wk.b.shape) == tuple(attn.wv.b.shape) == (
            tcfg.n_kv_heads * HEAD_DIM,)
        assert float(attn.wk.b.abs().max()) > 0
    else:
        assert biases == []


def test_prefill_and_decode_steps_match_reference(pair):
    """A prefill's logits, then four decode steps fed the reference's
    greedy tokens: logits within 1e-4 at each, tokens equal."""
    _, jcfg, params, tcfg, model, _ = pair
    prompt = _prompts(tcfg, 5)
    jl, jc = jax_make_prefill_step(jcfg, S + NEW)(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tl, tc = make_prefill_step(tcfg, S + NEW, device="cpu")(
        model, {"tokens": prompt})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jstep, tstep = jax_make_decode_step(jcfg), make_decode_step(
        tcfg, device="cpu")
    for i in range(NEW - 1):
        want = np.argmax(np.asarray(jl)[:, -1], axis=-1)
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1), want)
        jl, jc = jstep(params, jc, {"tokens": jnp.asarray(
            want[:, None], jnp.int32)}, jnp.int32(S + i))
        tl, tc = tstep(model, tc, {"tokens": torch.from_numpy(
            want[:, None])}, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {i}")
    np.testing.assert_allclose(tc["layers"]["k"].numpy(),
                               np.asarray(jc["layers"]["k"]), atol=ATOL)


def test_greedy_generate_matches_reference(pair):
    _, jcfg, params, tcfg, model, _ = pair
    prompt = _prompts(tcfg, 6)
    want = jax_greedy_generate(params, jcfg, jnp.asarray(prompt, jnp.int32),
                               max_new=NEW)
    got = greedy_generate(model, tcfg, prompt, max_new=NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_loss_and_per_leaf_gradients_match_reference(pair):
    _, jcfg, params, tcfg, model, _ = pair
    batch = _batch(tcfg, 7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: jax_zoo.loss_fn(p, jcfg, jb)[0])(params)
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss, _ = zoo.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
    finally:
        model.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    flat = {}
    for name, g in _flatten(want).items():
        g = np.asarray(g, np.float32)
        stack, _, rest = name.partition("/")
        if stack == "layers":
            for i in range(tcfg.n_layers):
                flat[f"layers.{i}.{rest.replace('/', '.')}"] = g[i]
        else:
            flat[name.replace("/", ".")] = g
    assert sorted(flat) == sorted(grads)
    for name, w in flat.items():
        np.testing.assert_allclose(grads[name].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rope_matches_reference_at_the_published_theta(arch):
    theta = get_config(arch).rope_theta
    np.testing.assert_array_equal(layers.rope_freqs(128, theta).numpy(),
                                  np.asarray(jax_layers.rope_freqs(128,
                                                                   theta)))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, 3, 128), dtype=np.float32)
    pos = np.sort(rng.choice(4096, 64, replace=False)).astype(np.int32)
    pos[-1] = 4095
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_published_param_counts(arch):
    """The full-width counts: the config's formula, the port's model on
    ``meta`` and the reference's, all the published total."""
    cfg = get_config(arch)
    assert cfg.param_count() == jax_get_config(arch).param_count() \
        == zoo.analytic_param_count(cfg) == PUBLISHED[arch]
    if arch == "qwen2-72b":
        cut = dataclasses.replace(cfg, n_layers=32)
        assert cut.param_count() == zoo.analytic_param_count(cut) == \
            QWEN2_32_LAYERS
