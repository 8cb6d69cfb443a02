"""The VLM family (``internvl2-26b``, reduced) on the port against the JAX
reference on the CPU: the projector's GELU (the tanh form, as
``jax.nn.gelu``'s default), ``forward`` and ``logits_fn`` with patch
embeddings leading the text tokens, ``loss_fn`` with the image positions
dropped and its gradient against ``jax.grad`` (the projector's leaves
included), a patch prefill through ``make_prefill_step`` and the decode
steps after it (at the prefill's full length, image tokens included),
``greedy_generate`` and the ``ContinuousBatcher`` on text prompts,
``input_specs``, and the carry-across of the ``projector`` leaves.
Weights are the reference's, carried across by ``params_from_numpy``;
inputs are made with numpy from a seed.  Everything is f32.

Tolerances: both packages compute in f32 and differ only in summation
order.  The GELU within 1e-6 of ``jax.nn.gelu`` (and more than 1e-4 from
the erf form on the same inputs, so the test tells them apart); hidden
states and logits within 1e-4; a prefill and decode steps within 1e-4;
greedy tokens equal; the loss within rtol 1e-5; every gradient leaf
within 1e-4 of its largest value.  The head width is the reduced
config's 16 (4 query heads on 1 KV head), and 64 where a case should
also suit the card's kernel."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import zoo as jax_zoo
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro.serve.serve_step import make_prefill_step as jax_make_prefill_step
from repro_torch.configs.base import SHAPES as PORT_SHAPES
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import params_from_numpy, zoo
from repro_torch.models.layers import gelu
from repro_torch.serve import (ContinuousBatcher, greedy_generate,
                               make_decode_step, make_prefill_step)

ARCH = "internvl2-26b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
ATOL = 1e-4


def _cfgs(**kw):
    kw = {**F32, **kw}
    return (dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduce_config(get_config(ARCH)), **kw))


@pytest.fixture(scope="module", params=[16, 64], ids=["hd16", "hd64"])
def vlm(request):
    jcfg, tcfg = _cfgs(head_dim=request.param)
    params = jax_zoo.init_model(jcfg, jax.random.key(0))
    # the reference draws zero projector biases; give them values so the
    # carry-across and the gradients of the biases are exercised
    rng = np.random.default_rng(11)
    params["projector"] = {
        fc: dict(p, b=jnp.asarray(rng.standard_normal(p["b"].shape,
                                                      dtype=np.float32)))
        for fc, p in params["projector"].items()}
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jcfg, tcfg, params, model


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(cfg, b, n_img, s, seed):
    """Patch embeddings [b, n_img, frontend_dim] and token ids [b, s] from
    a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n_img, cfg.frontend_dim),
                                dtype=np.float32) * 2,
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def test_projector_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    got = np32(gelu(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np32(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6)
    erf = np32(torch.nn.functional.gelu(torch.from_numpy(x)))
    assert float(np.abs(erf - got).max()) > 1e-4


def test_model_layout_matches_reference(vlm):
    jcfg, tcfg, params, model = vlm
    assert tuple(model.projector.fc1.w.shape) == (tcfg.frontend_dim,
                                                  tcfg.d_model)
    assert tuple(model.projector.fc2.b.shape) == (tcfg.d_model,)
    np.testing.assert_array_equal(np32(model.projector.fc1.b),
                                  np32(params["projector"]["fc1"]["b"]))


def test_forward_and_logits_match_reference(vlm):
    """8 projected image tokens ahead of 12 text tokens: the final hidden
    states of all 20 positions and the logits."""
    jcfg, tcfg, params, model = vlm
    pe, toks = _inputs(jcfg, 2, 8, 12, seed=1)
    want = jax_zoo.forward(params, jcfg, {"patch_embeds": jnp.asarray(pe),
                                          "tokens": jnp.asarray(toks)},
                           remat=False)
    got = zoo.forward(model, tcfg, {"patch_embeds": torch.from_numpy(pe),
                                    "tokens": torch.from_numpy(toks).long()},
                      remat=False)
    assert got.shape == (2, 20, tcfg.d_model)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL)
    np.testing.assert_allclose(np32(zoo.logits_fn(model, tcfg, got)),
                               np32(jax_zoo.logits_fn(params, jcfg, want)),
                               atol=ATOL)


def test_loss_drops_the_image_positions(vlm):
    jcfg, tcfg, params, model = vlm
    pe, toks = _inputs(jcfg, 2, 8, 17, seed=2)
    batch = {"patch_embeds": pe, "tokens": toks[:, :-1],
             "targets": toks[:, 1:]}
    want = jax_zoo.loss_fn(params, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()})[0]
    got, metrics = zoo.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(metrics["tokens"]) == 2 * 16


def test_patch_prefill_and_decode_match_reference(vlm):
    """``make_prefill_step`` on patches and text, then three decode steps
    at index n_img + S (the prefill's full length): logits within
    1e-4."""
    jcfg, tcfg, params, model = vlm
    pe, toks = _inputs(jcfg, 3, 8, 10, seed=3)
    nxt = np.random.default_rng(4).integers(0, jcfg.vocab, (3, 3, 1))
    jl, jc = jax_make_prefill_step(jcfg, 24)(
        params, {"patch_embeds": jnp.asarray(pe),
                 "tokens": jnp.asarray(toks)})
    tl, tc = make_prefill_step(tcfg, 24, device="cpu")(
        model, {"patch_embeds": pe, "tokens": toks})
    np.testing.assert_allclose(np32(tl), np32(jl), atol=ATOL)
    decode = make_decode_step(tcfg, device="cpu")
    for step in range(3):
        idx = 8 + 10 + step
        jl, jc = jax_zoo.decode_step(params, jcfg,
                                     {"tokens": jnp.asarray(nxt[step],
                                                            jnp.int32)},
                                     jc, cache_index=jnp.int32(idx))
        tl, tc = decode(model, tc, {"tokens": nxt[step]}, idx)
        np.testing.assert_allclose(np32(tl), np32(jl), atol=ATOL,
                                   err_msg=f"step {step}")
    for n in tc["layers"]:
        np.testing.assert_allclose(np32(tc["layers"][n]),
                                   np32(jc["layers"][n]), atol=ATOL)


def test_patch_prefill_and_step_equal_the_longer_prefill(vlm):
    """The port against itself: a prefill of 8 patches and 11 tokens and
    one decode step give the logits of a prefill of the same patches and
    12 tokens."""
    _, tcfg, _, model = vlm
    pe, toks = _inputs(tcfg, 2, 8, 12, seed=5)
    pe, t = torch.from_numpy(pe), torch.from_numpy(toks).long()
    caches = zoo.init_cache(tcfg, 2, 24, device="cpu")
    zoo.decode_step(model, tcfg, {"patch_embeds": pe, "tokens": t[:, :11]},
                    caches, cache_index=0)
    stepped, _ = zoo.decode_step(model, tcfg, {"tokens": t[:, 11:]}, caches,
                                 cache_index=8 + 11)
    whole, _ = zoo.decode_step(model, tcfg, {"patch_embeds": pe, "tokens": t},
                               zoo.init_cache(tcfg, 2, 24, device="cpu"),
                               cache_index=0)
    np.testing.assert_allclose(np32(stepped), np32(whole), atol=ATOL)


def test_greedy_generate_on_text_matches_reference(vlm):
    jcfg, tcfg, params, model = vlm
    _, toks = _inputs(jcfg, 3, 0, 13, seed=6)
    want = np.asarray(jax_greedy(params, jcfg, jnp.asarray(toks), max_new=8))
    got = greedy_generate(model, tcfg, toks, max_new=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_batcher_serves_text_as_the_reference(vlm):
    jcfg, tcfg, params, model = vlm
    jb = JaxBatcher(jcfg, params, slots=3, max_len=48)
    tb = ContinuousBatcher(tcfg, model, slots=3, max_len=48, device="cpu")
    for batcher in (jb, tb):
        rng = np.random.default_rng(7)
        for _ in range(5):
            batcher.submit(rng.integers(0, jcfg.vocab,
                                        int(rng.integers(5, 16)))
                           .astype(np.int32), max_new=int(rng.integers(3, 9)))
    ts, js = tb.run_until_drained(), jb.run_until_drained()
    for k in ("requests", "ticks", "tokens"):
        assert ts[k] == js[k], k
    assert ({r.rid: r.out_tokens for r in tb.finished}
            == {r.rid: r.out_tokens for r in jb.finished})


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    """Shapes and dtypes of every input, as ``meta`` tensors: at the
    reference's cells (1,024 image tokens) and at a short one (S // 4 of
    them)."""
    for name in (f"{kind}_4k" if kind == "train" else f"{kind}_32k", None):
        jshape = (SHAPES[name] if name else
                  dataclasses.replace(SHAPES["train_4k"], kind=kind,
                                      seq_len=40, global_batch=3))
        tshape = (PORT_SHAPES[name] if name else
                  dataclasses.replace(PORT_SHAPES["train_4k"], kind=kind,
                                      seq_len=40, global_batch=3))
        want = jax_zoo.input_specs(jax_get_config(ARCH), jshape)
        got = zoo.input_specs(get_config(ARCH), tshape)
        assert set(got) == set(want)
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == want[key].shape, key
            assert str(spec.dtype).split(".")[-1] == str(want[key].dtype)


def _unstack(tree, tcfg):
    """The reference's stacked tree as {port state_dict name: array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(p.key) for p in path)
        arr = np.asarray(leaf, np.float32)
        stack, _, rest = name.partition("/")
        if stack == "layers":
            for i in range(tcfg.n_layers):
                out[f"layers.{i}.{rest.replace('/', '.')}"] = arr[i]
        else:
            out[name.replace("/", ".")] = arr
    return out


def test_loss_gradients_match_jax_grad(vlm):
    """Every gradient leaf, the projector's included, within 1e-4 of its
    largest value against ``jax.grad(zoo.loss_fn)``."""
    jcfg, tcfg, params, model = vlm
    pe, toks = _inputs(jcfg, 2, 8, 15, seed=8)
    batch = {"patch_embeds": pe, "tokens": toks[:, :-1],
             "targets": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = _unstack(jax.grad(lambda p: jax_zoo.loss_fn(p, jcfg, jb)[0])(
        params), tcfg)
    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss, _ = zoo.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(named.values()))
    finally:
        model.requires_grad_(False)
    got = dict(zip(named, grads))
    assert set(got) == set(want)
    assert "projector.fc1.w" in got
    for name, g in got.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np32(g), w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_params_from_numpy_rejects_a_wrong_vlm_tree(fault):
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray,
                        jax_zoo.init_model(jcfg, jax.random.key(0)))
    if fault == "missing":
        del tree["projector"]["fc2"]
    else:
        tree["projector"]["fc3"] = tree["projector"]["fc2"]
    with pytest.raises(ValueError):
        params_from_numpy(tcfg, tree, device="cpu")


def test_full_width_param_count_equals_reference():
    """On ``meta``: 48 layers at d_model 6144, 48 / 8 heads of 128, d_ff
    16,384, vocab 92,553, the 3200 -> 6144 -> 6144 projector:
    19,918,682,112 parameters, the reference's
    ``analytic_param_count``."""
    cfg = get_config(ARCH)
    model = zoo.Model(cfg, device="meta")
    assert len(model.layers) == 48
    assert tuple(model.projector.fc1.w.shape) == (3200, 6144)
    total = sum(p.numel() for p in model.parameters())
    assert total == zoo.analytic_param_count(cfg) == \
        jax_zoo.analytic_param_count(jax_get_config(ARCH)) == 19_918_682_112
