"""Training on the port (``zoo.loss_fn`` and ``repro_torch.train``) against
the JAX reference on the CPU, at ``reduce_config(smollm-135m)`` with the
reference's weights carried across (``params_from_numpy``) and inputs made
with numpy from a seed; and train steps of every other family (MoE, SSM,
hybrid, MLA, encoder-decoder, VLM) at their ``reduce_config`` against the
reference's ``make_train_step``.

Tolerances (the attention gradient is held in
``tests/test_torch_flash_attention.py``): the loss rtol 1e-5 at f32 and
2e-2 at bf16 (bf16 rounds at other places in the two frameworks);
per-leaf gradients 1e-4 x the leaf's max|g| at f32; the optimizer rtol
1e-6 (and 1e-6 of a leaf's largest value, where a moment's update
cancels) on identical gradients (Adam's first step divides g by |g|, so
end to end a sign flip of a near-zero gradient would move a weight by 2
lr); five train steps' losses (two for the other families) 1e-4
relative at f32.  The hybrid's reference runs with its Mamba-2 decay
masked before the exp (``tests/_torch_ssd.py``): its own formula gives a
NaN gradient, which its first AdamW step writes into every weight."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import ssm as jax_ssm
from repro.models import zoo as jax_zoo
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import params_from_numpy, zoo
from repro_torch.models.convert import _flatten
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, lr_schedule)
from repro_torch.train.train_step import make_eval_step, make_train_step

import _torch_families as families
from _torch_ssd import segsum_decay_masked_first


def _configs(dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_reduce_config(
                jax_get_config("smollm-135m")), **kw),
            dataclasses.replace(reduce_config(get_config("smollm-135m")),
                                **kw))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(jax cfg, jax params, port cfg, port model) from the same weights."""
    jcfg, tcfg = _configs(request.param)
    params = jax_zoo.init_model(jcfg, jax.random.key(0))
    model = params_from_numpy(
        tcfg, jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def pair32():
    jcfg, tcfg = _configs("float32")
    params = jax_zoo.init_model(jcfg, jax.random.key(0))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jcfg, params, tcfg, model


def _batch(vocab, b=4, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_grads(model, cfg, batch, **kw):
    params = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss, _ = zoo.loss_fn(model, cfg, _torch(batch), **kw)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        model.requires_grad_(False)
    return loss.detach(), dict(zip(params, grads))


def _unstack(tree, n_layers):
    """The reference's stacked tree as {port state_dict name: array}."""
    out = {}
    for name, arr in _flatten(tree).items():
        arr = np.asarray(arr, np.float32)
        if name.startswith("layers/"):
            rest = name[len("layers/"):].replace("/", ".")
            for i in range(n_layers):
                out[f"layers.{i}.{rest}"] = arr[i]
        else:
            out[name.replace("/", ".")] = arr
    return out


# --------------------------------------------------------------------- loss
def test_loss_matches_reference(pair):
    jcfg, params, tcfg, model = pair
    batch = _batch(jcfg.vocab)
    want, jm = jax_zoo.loss_fn(params, jcfg, _jax(batch))
    got, metrics = zoo.loss_fn(model, tcfg, _torch(batch))
    rtol = 1e-5 if tcfg.param_dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 4 * 32
    assert got.dtype == torch.float32 and got.shape == ()


def test_per_leaf_gradients_match_reference(pair32):
    jcfg, params, tcfg, model = pair32
    batch = _batch(jcfg.vocab, seed=1)
    want = jax.grad(lambda p: jax_zoo.loss_fn(p, jcfg, _jax(batch))[0])(
        params)
    _, got = _port_grads(model, tcfg, batch)
    want = _unstack(want, jcfg.n_layers)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("n_chunk", [1, 2, 4])
def test_chunked_loss_equals_one_chunk(pair32, n_chunk):
    _, _, cfg, model = pair32
    batch = _batch(cfg.vocab, b=2, s=64, seed=2)
    logits_bytes = 2 * 64 * cfg.vocab * 4.0
    with mock.patch.object(zoo, "LOGITS_BUDGET", logits_bytes * 1.01):
        assert zoo.loss_chunks(2, 64, cfg.vocab) == 1
        one, _ = zoo.loss_fn(model, cfg, _torch(batch))
    with mock.patch.object(zoo, "LOGITS_BUDGET", logits_bytes / n_chunk):
        assert zoo.loss_chunks(2, 64, cfg.vocab) == n_chunk
        got, _ = zoo.loss_fn(model, cfg, _torch(batch))
    np.testing.assert_allclose(float(got), float(one), rtol=1e-6)


@pytest.mark.parametrize("b,s,vocab", [(8, 2048, 49152), (4, 32, 256),
                                       (2, 96, 49152), (1, 7, 1000)])
def test_chunk_count_is_the_reference_formula(b, s, vocab):
    # the reference's count, read from the length of its loss scan (the
    # only scan over a 1-d int range) at the smoke's shape and others
    jcfg = dataclasses.replace(jax_reduce_config(
        jax_get_config("smollm-135m")), vocab=vocab, n_layers=1)
    params = jax.eval_shape(lambda: jax_zoo.init_model(jcfg,
                                                       jax.random.key(0)))
    lengths = []
    real_scan = jax.lax.scan

    def spy(body, init, xs, *a, **kw):
        if hasattr(xs, "ndim") and xs.ndim == 1:
            lengths.append(xs.shape[0])
        return real_scan(body, init, xs, *a, **kw)

    spec = jax.ShapeDtypeStruct((b, s), jnp.int32)
    with mock.patch.object(jax.lax, "scan", spy):
        jax.eval_shape(lambda p, t: jax_zoo.loss_fn(
            p, jcfg, {"tokens": t, "targets": t}), params, spec)
    assert lengths and zoo.loss_chunks(b, s, vocab) == lengths[-1]


def test_smoke_shape_takes_sixteen_chunks():
    assert zoo.loss_chunks(8, 2048, 49152) == 16


def test_remat_on_and_off_same_bits(pair32):
    _, _, cfg, model = pair32
    batch = _batch(cfg.vocab, seed=3)
    l1, g1 = _port_grads(model, cfg, batch, remat=True)
    l0, g0 = _port_grads(model, cfg, batch, remat=False)
    assert torch.equal(l1, l0)
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def test_tied_embedding_takes_both_gradients(pair32):
    _, _, cfg, model = pair32
    assert cfg.tie_embeddings
    batch = _batch(cfg.vocab, seed=4)
    _, grads = _port_grads(model, cfg, batch)
    g = grads["embed.table"]
    # rows of tokens never fed in still get the output projection's part
    unused = np.setdiff1d(np.arange(cfg.vocab), batch["tokens"])
    assert unused.size and float(g[unused].abs().max()) > 0
    assert float(g[np.unique(batch["tokens"])].abs().max()) > 0


# --------------------------------------------------------------- optimizer
def _opt_trees(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 6), "b": (6,), "e": (10, 4), "s": (4,)}
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}, shapes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_five_steps(dtype):
    init, shapes = _opt_trees(dtype)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0,
                      weight_decay=0.1)
    jcfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                               clip_norm=1.0, weight_decay=0.1)
    jp = {n: jnp.asarray(a).astype(dtype) for n, a in init.items()}
    tp = {n: torch.from_numpy(a).to(getattr(torch, dtype))
          for n, a in init.items()}
    jo, to = jax_opt.init_opt_state(jp), init_opt_state(tp)
    assert ("master" in to) == ("master" in jo) == (dtype == "bfloat16")
    rng = np.random.default_rng(1)
    for step in range(5):
        # some steps clip (norm above 1), some do not
        g = {n: (rng.standard_normal(s) * (3.0 if step % 2 else 0.05))
             .astype(np.float32) for n, s in shapes.items()}
        jp, jo, jm = jax_opt.adamw_update(
            {n: jnp.asarray(a) for n, a in g.items()}, jo, jp, jcfg)
        tp, to, tm = adamw_update({n: torch.from_numpy(a)
                                   for n, a in g.items()}, to, tp, cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(to["step"]) == int(jo["step"]) == step + 1
        # rtol 1e-6, and atol 1e-6 of the leaf's largest value where a sum
        # cancels (m = b1 m + (1 - b1) g near 0; the two norms differ in
        # their last bit, so g * scale does too)
        for key in ("m", "v") + (("master",) if "master" in jo else ()):
            for n in shapes:
                want = np.asarray(jo[key][n])
                np.testing.assert_allclose(to[key][n].numpy(), want,
                                           rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=f"{key}/{n}")
        for n in shapes:
            want = np.asarray(jp[n].astype(jnp.float32))
            got = tp[n].float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=n)
            else:  # the master rounded to bf16, within one bf16 ulp
                assert torch.equal(tp[n], to["master"][n].bfloat16())
                np.testing.assert_allclose(got, want, rtol=2 ** -8,
                                           err_msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_sliced_leaves_same_bits(dtype, monkeypatch):
    """A leaf past ``optimizer.SLICE`` elements (qwen2-72b's embedding
    and ``lm_head``) is updated a slice of its flat view at a time: the
    same params, moments and master bit for bit as the whole leaf at
    once, over three steps, with a gradient that is not contiguous; the
    gradient norm then sums slices (rtol 1e-6)."""
    from repro_torch.train import optimizer

    init, shapes = _opt_trees(dtype)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    rng = np.random.default_rng(2)
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    runs = []
    for slice_at in (optimizer.SLICE, 7):
        monkeypatch.setattr(optimizer, "SLICE", slice_at)
        tp = {n: torch.from_numpy(a).to(getattr(torch, dtype))
              for n, a in init.items()}
        to, norms = init_opt_state(tp), []
        for g in grads:
            tg = {n: torch.from_numpy(a) for n, a in g.items()}
            tg["w"] = torch.from_numpy(np.ascontiguousarray(g["w"].T)).T
            assert not tg["w"].is_contiguous()
            tp, to, tm = adamw_update(tg, to, tp, cfg)
            norms.append(float(tm["grad_norm"]))
        runs.append((tp, to, norms))
    (p0, o0, n0), (p1, o1, n1) = runs
    np.testing.assert_allclose(n1, n0, rtol=1e-6)
    for n in shapes:
        assert torch.equal(p0[n], p1[n]), n
        for key in ("m", "v") + (("master",) if "master" in o0 else ()):
            assert torch.equal(o0[key][n], o1[key][n]), f"{key}/{n}"


def test_lr_schedule_matches_reference():
    for cfg_kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1),
                   dict(lr=3e-4, warmup_steps=100, total_steps=10000)):
        cfg, jcfg = AdamWConfig(**cfg_kw), jax_opt.AdamWConfig(**cfg_kw)
        got = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
               for s in range(121)]
        want = [float(jax_opt.lr_schedule(jcfg, jnp.int32(s)))
                for s in range(121)]
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(lr_schedule(cfg, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]          # warmup
    assert lrs[2] >= lrs[3] >= lrs[4]        # decay
    assert lrs[4] >= 0.1 * 1e-3 * 0.99       # floor


def test_clip_norm_applied():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 1e6)}
    opt = init_opt_state(params)
    _, _, m = adamw_update(grads, opt, params, AdamWConfig(clip_norm=1.0))
    assert float(m["grad_norm"]) > 1e6  # reported pre-clip


# -------------------------------------------------------------- train steps
def _train_steps_against_reference(arch, steps, jcfg=None, params=None):
    """``steps`` f32 steps of the port's ``make_train_step`` and the
    reference's (jitted) from the same weights and batches: each step's
    loss within rtol 1e-4."""
    if jcfg is None:
        jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                                   param_dtype="float32",
                                   compute_dtype="float32")
        params = jax_zoo.init_model(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(reduce_config(get_config(arch)),
                               param_dtype="float32", compute_dtype="float32")
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jcfg, jax_opt.AdamWConfig(**kw)))
    tstep = make_train_step(tcfg, AdamWConfig(**kw))
    jo = jax_opt.init_opt_state(params)
    to = init_opt_state(dict(model.named_parameters()))
    for i in range(steps):
        batch = families.batch(jcfg, 4, 32, np.random.default_rng(10 + i))
        params, jo, jm = jstep(params, jo, _jax(batch))
        model, to, tm = tstep(model, to, batch)
        assert np.isfinite(float(jm["loss"])), f"reference step {i}"
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert int(to["step"]) == steps
    assert not any(p.requires_grad for p in model.parameters())


def test_five_train_steps_match_reference(pair32):
    jcfg, params, _, _ = pair32
    _train_steps_against_reference("smollm-135m", 5, jcfg, params)


@pytest.mark.parametrize("family",
                         [f for f in families.FAMILIES if f != "dense"])
def test_train_steps_match_reference(family, monkeypatch):
    """Two f32 steps of each other family at its ``reduce_config``, as the
    dense family's five: the MoE routing (no gradient through the top-k),
    dispatch and combine; the SSM scan; the hybrid's shared block; MLA's
    attention at q.k 24 over v 16; the encoder and the cross-attention
    (32 queries over 8 frames); the VLM's projector."""
    monkeypatch.setattr(jax_ssm, "_segsum_decay", segsum_decay_masked_first)
    _train_steps_against_reference(families.FAMILIES[family], 2)


def test_grad_accumulation_matches_full_batch():
    cfg = reduce_config(get_config("smollm-135m"))
    model = init_model_from_seed(cfg)
    opt = init_opt_state(dict(model.named_parameters()))
    batch = _batch(cfg.vocab, b=8)
    s1 = make_train_step(cfg, AdamWConfig(lr=1e-3), microbatches=1)
    s4 = make_train_step(cfg, AdamWConfig(lr=1e-3), microbatches=4)
    m1, o1 = init_model_from_seed(cfg), init_opt_state(
        dict(model.named_parameters()))
    m4, o4 = init_model_from_seed(cfg), init_opt_state(
        dict(model.named_parameters()))
    m1, _, r1 = s1(m1, o1, batch)
    m4, _, r4 = s4(m4, o4, batch)
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 1e-2
    for (n, a), (_, b) in zip(m1.state_dict().items(),
                              m4.state_dict().items()):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=5e-3, err_msg=n)


def test_grad_accumulation_f32_loss_and_grads(pair32):
    # at f32 the microbatch mean equals the full batch's to float error
    _, _, cfg, model = pair32
    batch = _batch(cfg.vocab, b=8, seed=5)
    full, gf = _port_grads(model, cfg, batch)
    parts = [_port_grads(model, cfg, {k: v[2 * i:2 * i + 2]
                                      for k, v in batch.items()})
             for i in range(4)]
    np.testing.assert_allclose(float(sum(p[0] for p in parts) / 4),
                               float(full), rtol=1e-6)
    for name, g in gf.items():
        acc = sum(p[1][name] for p in parts) / 4
        torch.testing.assert_close(acc, g, rtol=0,
                                   atol=1e-5 * float(g.abs().max()))


def init_model_from_seed(cfg):
    from repro_torch.models import init_model

    return init_model(cfg, 0, device="cpu")


def test_loss_decreases_on_fixed_batch():
    cfg = reduce_config(get_config("smollm-135m"))
    model = init_model_from_seed(cfg)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2,
                                            total_steps=30))
    opt = init_opt_state(dict(model.named_parameters()))
    batch = _batch(cfg.vocab)
    losses = []
    for _ in range(25):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_eval_step_matches_loss(pair32):
    _, _, cfg, model = pair32
    batch = _batch(cfg.vocab, seed=6)
    got = make_eval_step(cfg)(model, batch)
    want, _ = zoo.loss_fn(model, cfg, _torch(batch))
    assert float(got["loss"]) == float(want)
