"""The encoder-decoder family (``seamless-m4t-medium``, reduced) on the
port against the JAX reference on the CPU: ``encode_frames``, ``forward``
and ``logits_fn``, ``loss_fn`` and its gradient against ``jax.grad``
(through the plain attention backward, cross-attention's keys of another
length than its queries), ``decode_step`` over ``enc_out``, the prefill
through ``make_prefill_step`` (frames encoded first), ``greedy_generate``
with ``enc_out``, ``input_specs``, the carry-across of the tree's
``enc_layers``, ``dec_layers`` (``cross``, ``ln_x``) and ``enc_norm``
leaves, and the batcher's and the launcher's refusal of the family.
Weights are the reference's, carried across by ``params_from_numpy``;
inputs are made with numpy from a seed.  Everything is f32.

Tolerances: both packages compute in f32 and differ only in summation
order.  The encoder's output and the decoder's hidden states within 1e-4
(LayerNorm outputs of unit scale, two layers each), logits within 1e-4,
a prefill and decode steps within 1e-4 of the reference's, greedy tokens
equal, the loss within rtol 1e-5, and every gradient leaf within 1e-4 of
its largest value.  The head width is the reduced config's 16, and 64
where a case should also suit the card's kernel."""
import dataclasses
import subprocess
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import zoo as jax_zoo
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro.serve.serve_step import make_decode_step as jax_make_decode_step
from repro.serve.serve_step import make_prefill_step as jax_make_prefill_step
from repro_torch.configs.base import SHAPES as PORT_SHAPES
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import params_from_numpy, zoo
from repro_torch.serve import (ContinuousBatcher, greedy_generate,
                               make_decode_step, make_prefill_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
F32 = dict(param_dtype="float32", compute_dtype="float32")
ATOL = 1e-4


def _cfgs(**kw):
    kw = {**F32, **kw}
    return (dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduce_config(get_config(ARCH)), **kw))


def _carried(jcfg, tcfg, seed=0):
    params = jax_zoo.init_model(jcfg, jax.random.key(seed))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return params, model


@pytest.fixture(scope="module", params=[16, 64], ids=["hd16", "hd64"])
def seamless(request):
    jcfg, tcfg = _cfgs(head_dim=request.param)
    return (jcfg, tcfg, *_carried(jcfg, tcfg))


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(cfg, b, s, se, seed):
    """Token ids [b, s] and frame embeddings [b, se, d_model] from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.standard_normal((b, se, cfg.d_model), dtype=np.float32))


def test_model_layout_matches_reference(seamless):
    """``enc_layers``, ``enc_norm`` and ``dec_layers`` (with ``ln_x`` and
    ``cross``) under the reference's keys, no ``layers``; the decode
    cache is {"dec": {"k", "v"}} of the reference's shapes."""
    jcfg, tcfg, params, model = seamless
    assert model.layers is None and len(model.enc_layers) == 2
    assert len(model.dec_layers) == tcfg.n_layers
    assert {n for n, _ in model.dec_layers[0].named_children()} == {
        "ln1", "attn", "ln_x", "cross", "ln2", "mlp"}
    assert {n for n, _ in model.enc_layers[0].named_children()} == {
        "ln1", "attn", "ln2", "mlp"}
    caches = zoo.init_cache(tcfg, 2, 16, device="cpu")
    jcaches = jax_zoo.init_cache(jcfg, 2, 16)
    assert set(caches) == set(jcaches) == {"dec"}
    for n in caches["dec"]:
        assert tuple(caches["dec"][n].shape) == jcaches["dec"][n].shape


def test_encode_frames_matches_reference(seamless):
    jcfg, tcfg, params, model = seamless
    _, frames = _inputs(jcfg, 2, 8, 12, seed=1)
    want = jax_zoo.encode_frames(params, jcfg, jnp.asarray(frames))
    got = zoo.encode_frames(model, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, 12, tcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL)


def test_forward_and_logits_match_reference(seamless):
    """The decoder's final hidden states over 20 tokens, cross-attending
    over 12 encoded frames (the kernel's path: queries and keys of two
    lengths), and the logits of every position."""
    jcfg, tcfg, params, model = seamless
    toks, frames = _inputs(jcfg, 2, 20, 12, seed=2)
    want = jax_zoo.forward(params, jcfg, {"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(frames)},
                           remat=False)
    got = zoo.forward(model, tcfg, {"tokens": torch.from_numpy(toks).long(),
                                    "frames": torch.from_numpy(frames)},
                      remat=False)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL)
    np.testing.assert_allclose(np32(zoo.logits_fn(model, tcfg, got)),
                               np32(jax_zoo.logits_fn(params, jcfg, want)),
                               atol=ATOL)


def test_loss_matches_reference(seamless):
    jcfg, tcfg, params, model = seamless
    toks, frames = _inputs(jcfg, 2, 25, 6, seed=3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "frames": frames}
    want = jax_zoo.loss_fn(params, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()})[0]
    got, metrics = zoo.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(metrics["tokens"]) == 2 * 24


def test_decode_step_with_enc_out_matches_reference(seamless):
    """A prefill of 10 tokens with ``enc_out`` given, then four decode
    steps reading ``batch["enc_out"]``: logits and the decoder's caches
    within 1e-4."""
    jcfg, tcfg, params, model = seamless
    toks, frames = _inputs(jcfg, 2, 10, 7, seed=4)
    nxt = np.random.default_rng(5).integers(0, jcfg.vocab, (4, 2, 1))
    jenc = jax_zoo.encode_frames(params, jcfg, jnp.asarray(frames))
    tenc = zoo.encode_frames(model, tcfg, torch.from_numpy(frames))
    jc = jax_zoo.init_cache(jcfg, 2, 16)
    tc = zoo.init_cache(tcfg, 2, 16, device="cpu")
    want, jc = jax_zoo.decode_step(params, jcfg,
                                   {"tokens": jnp.asarray(toks)}, jc,
                                   cache_index=jnp.int32(0), enc_out=jenc)
    got, tc = zoo.decode_step(model, tcfg,
                              {"tokens": torch.from_numpy(toks).long()}, tc,
                              cache_index=0, enc_out=tenc)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL)
    for step in range(4):
        want, jc = jax_zoo.decode_step(
            params, jcfg, {"tokens": jnp.asarray(nxt[step], jnp.int32),
                           "enc_out": jenc}, jc,
            cache_index=jnp.int32(10 + step))
        got, tc = zoo.decode_step(
            model, tcfg, {"tokens": torch.from_numpy(nxt[step]),
                          "enc_out": tenc}, tc, cache_index=10 + step)
        assert got.shape == (2, 1, tcfg.vocab)
        np.testing.assert_allclose(np32(got), np32(want), atol=ATOL,
                                   err_msg=f"step {step}")
    for n in tc["dec"]:
        np.testing.assert_allclose(np32(tc["dec"][n]), np32(jc["dec"][n]),
                                   atol=ATOL)


def test_prefill_step_encodes_frames_as_the_reference(seamless):
    """``make_prefill_step`` runs ``encode_frames`` on ``batch["frames"]``
    before the decoder, and ``make_decode_step`` reads
    ``batch["enc_out"]``, as the reference's steps."""
    jcfg, tcfg, params, model = seamless
    toks, frames = _inputs(jcfg, 3, 9, 5, seed=6)
    jl, jc = jax_make_prefill_step(jcfg, 12)(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    tl, tc = make_prefill_step(tcfg, 12, device="cpu")(
        model, {"tokens": toks, "frames": frames})
    np.testing.assert_allclose(np32(tl), np32(jl), atol=ATOL)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    jenc = jax_zoo.encode_frames(params, jcfg, jnp.asarray(frames))
    jl, _ = jax_make_decode_step(jcfg)(
        params, jc, {"tokens": jnp.asarray(tok, jnp.int32), "enc_out": jenc},
        jnp.int32(9))
    tl, _ = make_decode_step(tcfg, device="cpu")(
        model, tc, {"tokens": tok, "enc_out": np.asarray(jenc)}, 9)
    np.testing.assert_allclose(np32(tl), np32(jl), atol=ATOL)


def test_greedy_generate_with_enc_out_matches_reference(seamless):
    jcfg, tcfg, params, model = seamless
    toks, frames = _inputs(jcfg, 3, 11, 9, seed=7)
    jenc = jax_zoo.encode_frames(params, jcfg, jnp.asarray(frames))
    want = np.asarray(jax_greedy(params, jcfg, jnp.asarray(toks), max_new=8,
                                 enc_out=jenc))
    tenc = zoo.encode_frames(model, tcfg, torch.from_numpy(frames))
    got = greedy_generate(model, tcfg, toks, max_new=8, enc_out=tenc,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="enc_out"):
        greedy_generate(model, tcfg, toks, max_new=2, device="cpu")


def test_prefill_and_step_equal_the_longer_prefill(seamless):
    """The port against itself: a prefill of 12 tokens and one decode step
    over the same ``enc_out`` give the logits of a prefill of 13."""
    _, tcfg, _, model = seamless
    toks, frames = _inputs(tcfg, 2, 13, 6, seed=8)
    t = torch.from_numpy(toks).long()
    enc = zoo.encode_frames(model, tcfg, torch.from_numpy(frames))
    caches = zoo.init_cache(tcfg, 2, 16, device="cpu")
    zoo.decode_step(model, tcfg, {"tokens": t[:, :12]}, caches,
                    cache_index=0, enc_out=enc)
    stepped, _ = zoo.decode_step(model, tcfg, {"tokens": t[:, 12:]}, caches,
                                 cache_index=12, enc_out=enc)
    whole, _ = zoo.decode_step(model, tcfg, {"tokens": t},
                               zoo.init_cache(tcfg, 2, 16, device="cpu"),
                               cache_index=0, enc_out=enc)
    np.testing.assert_allclose(np32(stepped), np32(whole), atol=ATOL)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    """Shapes and dtypes of every input, as ``meta`` tensors, at the
    reference's cells and at a short one."""
    for name in (f"{kind}_4k" if kind == "train" else f"{kind}_32k", None):
        jshape = (SHAPES[name] if name else
                  dataclasses.replace(SHAPES["train_4k"], kind=kind,
                                      seq_len=2, global_batch=3))
        tshape = (PORT_SHAPES[name] if name else
                  dataclasses.replace(PORT_SHAPES["train_4k"], kind=kind,
                                      seq_len=2, global_batch=3))
        want = jax_zoo.input_specs(jax_get_config(ARCH), jshape)
        got = zoo.input_specs(get_config(ARCH), tshape)
        assert set(got) == set(want)
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == want[key].shape, key
            assert str(spec.dtype).split(".")[-1] == str(want[key].dtype)


def _unstack(tree, tcfg):
    """The reference's stacked tree as {port state_dict name: array}."""
    stacks = {"enc_layers": tcfg.enc_layers, "dec_layers": tcfg.n_layers}
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


def test_loss_gradients_match_jax_grad(seamless):
    """Every gradient leaf, the encoder's and the cross-attention's
    included (the plain backward at 16 queries over 9 keys), within 1e-4
    of its largest value against ``jax.grad(zoo.loss_fn)``."""
    jcfg, tcfg, params, model = seamless
    toks, frames = _inputs(jcfg, 2, 17, 9, seed=9)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "frames": frames}
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
    assert any(".cross.wk." in n for n in got)
    for name, g in got.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np32(g), w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_from_numpy_rejects_a_wrong_encdec_tree(fault):
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray,
                        jax_zoo.init_model(jcfg, jax.random.key(0)))
    if fault == "missing":
        del tree["dec_layers"]["cross"]["wq"]
    elif fault == "extra":
        tree["layers"] = tree["dec_layers"]
    else:
        tree["enc_norm"]["scale"] = tree["enc_norm"]["scale"][:-1]
    with pytest.raises(ValueError):
        params_from_numpy(tcfg, tree, device="cpu")


def test_full_width_param_count_equals_reference():
    """On ``meta``: 12 encoder and 12 decoder layers at d_model 1024, 16
    heads of 64, LayerNorm, vocab 256,206: 977,821,696 parameters, the
    reference's ``analytic_param_count``."""
    cfg = get_config(ARCH)
    model = zoo.Model(cfg, device="meta")
    assert len(model.enc_layers) == 12 and len(model.dec_layers) == 12
    assert tuple(model.dec_layers[0].cross.wk.w.shape) == (1024, 1024)
    total = sum(p.numel() for p in model.parameters())
    assert total == zoo.analytic_param_count(cfg) == \
        jax_zoo.analytic_param_count(jax_get_config(ARCH)) == 977_821_696


def test_batcher_and_launcher_refuse_the_family(seamless):
    """The reference's batcher and launcher pass no ``enc_out``: the
    port's refuse the family with that reason, and do not crash."""
    _, tcfg, _, model = seamless
    with pytest.raises(NotImplementedError, match="enc_out"):
        ContinuousBatcher(tcfg, model, slots=2, max_len=16, device="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                     "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2, proc.stderr
    assert "enc_out" in proc.stderr and "Traceback" not in proc.stderr
