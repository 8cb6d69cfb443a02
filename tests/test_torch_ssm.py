"""The SSM (Mamba-1) and hybrid (Zamba2) families on the port
(``repro_torch.models.ssm``, the ``ssm1`` / ``ssm2`` blocks and the
hybrid stack of ``zoo``) against the JAX reference on the CPU: the causal
conv, the segment-sum decay, both chunked scans (several chunks, a
carried state, a length that is not a multiple of the chunk), both
mixers with and without a decode state, the blocks, and reduced
``falcon-mamba-7b``, reduced ``zamba2-1.2b`` and a hybrid with a
trailing layer as whole models: forward, loss, every gradient leaf
against ``jax.grad``, and a prefill then three decode steps with the
states compared; the full configs' parameter counts, and the
deterministic leaves bit for bit.  The reference's Mamba-2 gradient is
NaN (its decay matrix masks after an exp that overflows); the port's is
finite, and is held against the reference with its decay masked before
the exp (``tests/_torch_ssd.py``), which changes none of its values.
Weights are the reference's, carried across by ``params_from_numpy``;
inputs are made with numpy from a seed.

Tolerances: f32 within 1e-4 (both frameworks compute in f32 and differ
in summation order: the port's associative scan combines in the
reference's order but may round a multiply-add that XLA fuses); bf16 at
the reference's own bf16 tolerance (atol 0.15, rtol 0.05), as
``tests/test_torch_models.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import blocks as jax_blocks
from repro.models import ssm as jax_ssm
from repro.models import zoo as jax_zoo
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import blocks, params_from_numpy, ssm, zoo

from _torch_ssd import segsum_decay_masked_first

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-1.2b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
ATOL_F32 = 1e-4
BF16 = dict(atol=0.15, rtol=0.05)
#: whole-model cases: (arch, overrides of the reduced config)
MODELS = {"falcon": (FALCON, {}), "zamba2": (ZAMBA, {}),
          "hybrid-trailing": (ZAMBA, dict(n_layers=5))}


def _reduced(arch, **kw):
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                                **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


def _carried(jcfg, tcfg, seed=0):
    params = jax_zoo.init_model(jcfg, jax.random.key(seed))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return params, model


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def both(x):
    """``x`` as a jnp array and a torch tensor (f32)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def close(got, want, **tol):
    np.testing.assert_allclose(np32(got), np32(want),
                               **(tol or dict(atol=ATOL_F32)))


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_reference(carry):
    rng = np.random.default_rng(0)
    jx, tx = both(rng.standard_normal((2, 9, 12)))
    jw, tw = both(rng.standard_normal((4, 12)))
    jb, tb = both(rng.standard_normal(12))
    state = rng.standard_normal((2, 3, 12)) if carry else None
    js, ts = both(state) if carry else (None, None)
    jy, jnew = jax_ssm._causal_conv(jx, jw, jb, js)
    ty, tnew = ssm._causal_conv(tx, tw, tb, ts)
    close(ty, jy)
    close(tnew, jnew)
    assert tuple(tnew.shape) == (2, 3, 12)


def test_segsum_decay_matches_reference():
    la = -np.random.default_rng(1).uniform(0, 2, (2, 3, 10))
    jl, tl = both(la)
    want = jax_ssm._segsum_decay(jl)
    got = ssm._segsum_decay(tl)
    close(got, want)
    assert float(got[0, 0, 2, 5]) == 0.0  # above the diagonal


def test_segsum_decay_masks_before_the_exp():
    """Where a sum above the diagonal overflows exp in f32 (decays' logs
    down to -40 over 10 steps), the port's decay equals the reference's
    formula (mask after the exp) bit for bit and the reference's value,
    while the reference's gradient is NaN and the port's finite, equal to
    the gradient of the reference masked first."""
    la = -np.random.default_rng(2).uniform(0, 40, (2, 3, 10))
    jl, tl = both(la)
    w = np.random.default_rng(3).standard_normal((2, 3, 10, 10))
    jw, tw = both(w)
    got = ssm._segsum_decay(tl)
    cs = torch.cumsum(tl, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((10, 10), dtype=torch.bool))
    assert torch.equal(got, torch.where(mask, torch.exp(diff),
                                        torch.zeros_like(diff)))
    close(got, jax_ssm._segsum_decay(jl))
    assert float(diff.max()) > 88.8  # exp overflows above the diagonal

    def jloss(fn):
        return jax.grad(lambda x: jnp.sum(fn(x) * jw))(jl)

    assert np.isnan(np.asarray(jloss(jax_ssm._segsum_decay))).any()
    tx = tl.clone().requires_grad_()
    (gx,) = torch.autograd.grad((ssm._segsum_decay(tx) * tw).sum(), tx)
    assert torch.isfinite(gx).all()
    close(gx, jloss(segsum_decay_masked_first))


SCANS = [(16, 4), (16, 16), (12, 5), (7, 16), (1, 4)]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S,chunk", SCANS)
def test_mamba1_scan_matches_reference(S, chunk, h0):
    """Several chunks (16/4), one (16/16), S not a multiple of the chunk
    (12/5: one chunk of 12), S below the chunk, a decode step (S = 1)."""
    rng = np.random.default_rng(S * 31 + chunk)
    B, di, N = 2, 6, 4
    jdA, tdA = both(np.exp(-rng.uniform(0, 1.5, (B, S, di, N))))
    jdBx, tdBx = both(rng.standard_normal((B, S, di, N)))
    jC, tC = both(rng.standard_normal((B, S, N)))
    jh, th = both(rng.standard_normal((B, di, N))) if h0 else (None, None)
    jy, jlast = jax_ssm._mamba1_scan(jdA, jdBx, jC, chunk, jh)
    ty, tlast = ssm._mamba1_scan(tdA, tdBx, tC, chunk, th)
    close(ty, jy)
    close(tlast, jlast)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 33])
def test_linear_scan_is_the_recurrence(n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (2, n, 3)))
    b = torch.from_numpy(rng.standard_normal((2, n, 3)))
    got_a, got_b = ssm._linear_scan(a, b)
    h, p = torch.zeros(2, 3, dtype=a.dtype), torch.ones(2, 3, dtype=a.dtype)
    for t in range(n):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        torch.testing.assert_close(got_b[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_a[:, t], p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S,chunk", SCANS)
def test_ssd_chunked_matches_reference(S, chunk, h0):
    rng = np.random.default_rng(S * 17 + chunk)
    B, H, P, N = 2, 3, 4, 5
    jx, tx = both(rng.standard_normal((B, S, H, P)))
    jdt, tdt = both(np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    jA, tA = both(-np.linspace(1.0, 4.0, H))
    jB, tB = both(rng.standard_normal((B, S, N)))
    jC, tC = both(rng.standard_normal((B, S, N)))
    jh, th = both(rng.standard_normal((B, H, P, N))) if h0 else (None, None)
    jy, jlast = jax_ssm._ssd_chunked(jx, jdt, jA, jB, jC, chunk, jh)
    ty, tlast = ssm._ssd_chunked(tx, tdt, tA, tB, tC, chunk, th)
    close(ty, jy)
    close(tlast, jlast)


# ------------------------------------------------------------------ mixers
def _state(cfg, kind, rng, batch):
    """A random decode state of one layer, as numpy arrays."""
    specs = (ssm.mamba1_state_specs if kind == "ssm1"
             else ssm.mamba2_state_specs)(cfg, batch)
    return {n: (rng.standard_normal(tuple(t.shape)) * 0.5).astype(np.float32)
            for n, t in specs.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("arch,kind", [(FALCON, "ssm1"), (ZAMBA, "ssm2")])
def test_mixer_matches_reference(arch, kind, with_state):
    jcfg, tcfg = _reduced(arch, **F32)
    params, model = _carried(jcfg, tcfg)
    jp = jax.tree.map(lambda a: a[1], params["layers"]["mamba"])
    tp = model.layers[1].mamba
    rng = np.random.default_rng(2)
    jx, tx = both(rng.standard_normal((2, 20, jcfg.d_model)))
    st = _state(tcfg, kind, rng, 2) if with_state else None
    jst = {n: jnp.asarray(v) for n, v in st.items()} if st else None
    tst = {n: torch.from_numpy(v) for n, v in st.items()} if st else None
    jfn = jax_ssm.mamba1_apply if kind == "ssm1" else jax_ssm.mamba2_apply
    tfn = ssm.mamba1_apply if kind == "ssm1" else ssm.mamba2_apply
    want, jnew = jfn(jp, jx, jcfg, state=jst)
    got, tnew = tfn(tp, tx, tcfg, state=tst)
    close(got, want)
    assert (tnew is None) == (not with_state)
    if with_state:
        assert set(tnew) == set(jnew)
        for n in jnew:
            assert tnew[n].dtype == torch.float32
            close(tnew[n], jnew[n])
        # the given state is read, not written
        for n, v in st.items():
            np.testing.assert_array_equal(tst[n].numpy(), v)


@pytest.mark.parametrize("arch,kind", [(FALCON, "ssm1"), (ZAMBA, "ssm2")])
def test_block_apply_matches_reference(arch, kind):
    jcfg, tcfg = _reduced(arch, **F32)
    params, model = _carried(jcfg, tcfg)
    jp = jax.tree.map(lambda a: a[0], params["layers"])
    x = np.random.default_rng(3).standard_normal((2, 24, jcfg.d_model))
    jx, tx = both(x)
    want, _ = jax_blocks.block_apply(jp, jx, jcfg, kind)
    got, none = blocks.block_apply(model.layers[0], tx, tcfg, kind)
    assert none is None
    close(got, want)


# ------------------------------------------------------------------ models
def _model_case(case, **kw):
    arch, over = MODELS[case]
    return _reduced(arch, **{**over, **kw})


def _tokens(cfg, b, s, seed):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("S", [32, 40])
@pytest.mark.parametrize("case", list(MODELS))
def test_forward_and_loss_match_reference(case, S):
    """S = 32 runs two chunks of 16; S = 40 one chunk of 40."""
    jcfg, tcfg = _model_case(case, **F32)
    params, model = _carried(jcfg, tcfg)
    jt, tt = _tokens(jcfg, 2, S, seed=4)
    want = jax_zoo.forward(params, jcfg, {"tokens": jt}, remat=False)
    got = zoo.forward(model, tcfg, {"tokens": tt})
    close(got, want)
    jtg, ttg = _tokens(jcfg, 2, S, seed=5)
    jl, _ = jax_zoo.loss_fn(params, jcfg, {"tokens": jt, "targets": jtg})
    tl, metrics = zoo.loss_fn(model, tcfg, {"tokens": tt, "targets": ttg})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(metrics["tokens"]) == 2 * S


def _unstack(tree, n_layers):
    """The reference's stacked tree as {port state_dict name: array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(p.key) for p in path)
        arr = np.asarray(leaf, np.float32)
        stack, _, rest = name.partition("/")
        if stack == "layers":
            for i in range(n_layers):
                out[f"layers.{i}.{rest.replace('/', '.')}"] = arr[i]
        else:
            out[name.replace("/", ".")] = arr
    return out


@pytest.mark.parametrize("case", list(MODELS))
def test_loss_gradients_match_jax_grad(case, monkeypatch):
    """Every gradient leaf (the scans', the convs', ``A_log``, ``D``,
    ``dt_bias`` and the shared block's) within 1e-4 of its largest value
    against ``jax.grad(zoo.loss_fn)``, at S = 32: two chunks of 16, so the
    carried state's gradient crosses a chunk boundary.  The reference runs
    with its Mamba-2 decay masked before the exp (its own formula gives a
    NaN gradient: ``test_segsum_decay_masks_before_the_exp``)."""
    monkeypatch.setattr(jax_ssm, "_segsum_decay", segsum_decay_masked_first)
    jcfg, tcfg = _model_case(case, **F32)
    params, model = _carried(jcfg, tcfg)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 33))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    want = _unstack(jax.jit(jax.grad(
        lambda p: jax_zoo.loss_fn(p, jcfg, jb)[0]))(params), jcfg.n_layers)
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
    for name, g in got.items():
        w = want[name]
        assert np.isfinite(w).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np32(g), w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MODELS))
def test_decode_step_matches_reference(case, dtype):
    """A prefill of 32 tokens (two chunks), then three decode steps; the
    logits and every cache entry (SSM and conv states, the shared block's
    KV cache) against the reference's."""
    jcfg, tcfg = _model_case(case, param_dtype="float32",
                             compute_dtype=dtype)
    params, model = _carried(jcfg, tcfg)
    B, S, max_len = 2, 32, 40
    jt, tt = _tokens(jcfg, B, S, seed=6)
    jc = jax_zoo.init_cache(jcfg, B, max_len)
    tc = zoo.init_cache(tcfg, B, max_len, device="cpu")
    assert set(tc) == set(jc)
    for key in jc:
        assert set(tc[key]) == set(jc[key])
        for n in jc[key]:
            assert tuple(tc[key][n].shape) == jc[key][n].shape, (key, n)
            assert str(tc[key][n].dtype)[6:] == str(jc[key][n].dtype)
    tol = dict(atol=ATOL_F32) if dtype == "float32" else BF16
    nxt = np.random.default_rng(7).integers(0, jcfg.vocab, (3, B, 1))
    for step in range(4):
        idx = 0 if step == 0 else S + step - 1
        jb = jt if step == 0 else jnp.asarray(nxt[step - 1], jnp.int32)
        tb = tt if step == 0 else torch.from_numpy(nxt[step - 1])
        want, jc = jax_zoo.decode_step(params, jcfg, {"tokens": jb}, jc,
                                       cache_index=jnp.int32(idx))
        got, tc2 = zoo.decode_step(model, tcfg, {"tokens": tb}, tc,
                                   cache_index=idx)
        assert tc2 is tc  # updated in place
        assert got.shape == (B, 1, tcfg.vocab) and got.dtype == torch.float32
        close(got, want, **tol)
        for key in jc:
            for n in jc[key]:
                close(tc[key][n], jc[key][n], **tol)


@pytest.mark.parametrize("case", list(MODELS))
def test_prefill_then_decode_equals_a_longer_prefill(case):
    """The carried state: a prefill of 32 tokens (two chunks) and one
    decode step agree with a prefill of 33 (one chunk of 33)."""
    _, tcfg = _model_case(case, **F32)
    model = zoo.init_model(tcfg, 0, device="cpu")
    t = torch.from_numpy(np.random.default_rng(8).integers(0, tcfg.vocab,
                                                           (2, 33)))
    caches = zoo.init_cache(tcfg, 2, 40, device="cpu")
    zoo.decode_step(model, tcfg, {"tokens": t[:, :32]}, caches,
                    cache_index=0)
    got, _ = zoo.decode_step(model, tcfg, {"tokens": t[:, 32:]}, caches,
                             cache_index=32)
    want, _ = zoo.decode_step(model, tcfg, {"tokens": t},
                              zoo.init_cache(tcfg, 2, 40, device="cpu"),
                              cache_index=0)
    close(got, want)


def test_zero_ssm_state_keeps_the_kv_cache():
    _, tcfg = _model_case("zamba2", **F32)
    caches = zoo.init_cache(tcfg, 2, 8, device="cpu")
    for stack in caches.values():
        for t in stack.values():
            t.fill_(1.0)
    zoo.zero_ssm_state(tcfg, caches)
    assert all(float(t.abs().max()) == 0.0
               for t in caches["layers"].values())
    assert all(float(t.min()) == 1.0 for t in caches["shared"].values())


def test_hybrid_stack_layout():
    _, tcfg = _model_case("hybrid-trailing", **F32)
    assert zoo._hybrid_sites(tcfg) == (2, 1)
    model = zoo.Model(tcfg, device="meta")
    assert len(model.layers) == 5 and model.shared_attn is not None
    wide = 2 * tcfg.d_model
    assert tuple(model.shared_attn.attn.wq.w.shape) == (wide, wide)
    assert tuple(model.shared_attn.out_proj.w.shape) == (wide, tcfg.d_model)
    specs = zoo.init_cache_specs(tcfg, 3, 11)
    assert tuple(specs["shared"]["k"].shape) == (
        2, 3, 11, tcfg.n_kv_heads, wide // tcfg.n_heads)
    assert specs["layers"]["ssm"].dtype == torch.float32
    assert specs["layers"]["conv_x"].shape[0] == 5


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("arch,count", [(FALCON, 7_272_665_088),
                                        (ZAMBA, 1_279_529_856)])
def test_full_width_parameter_counts(arch, count):
    cfg = get_config(arch)
    assert zoo.analytic_param_count(cfg) == count
    assert zoo.analytic_param_count(cfg, active_only=True) == count
    assert jax_zoo.analytic_param_count(jax_get_config(arch)) == count
    assert cfg.param_count() == count


SET_LEAVES = ("A_log", "D", "dt_bias", "conv_b", "conv_x_b", "conv_B_b",
              "conv_C_b", "dt_proj.b", "scale")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", [
    (FALCON, {}), (ZAMBA, {}),
    # falcon's N = 16 at full width, zamba2's H = 64 at full width
    (FALCON, dict(d_state=16)), (ZAMBA, dict(headdim=2))])
def test_deterministic_leaves_equal_exactly(arch, kw, dtype):
    jcfg, tcfg = _reduced(arch, param_dtype=dtype)
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, **kw))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, **kw))
    tree = jax.tree.map(np.asarray,
                        jax_zoo.init_model(jcfg, jax.random.key(0)))
    model = zoo.init_model(tcfg, 1, device="cpu")
    state = model.state_dict()
    names = [n for n in state if n.split(".")[-1] in SET_LEAVES
             or n.endswith("dt_proj.b")]
    assert any(n.endswith("A_log") for n in names)
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            leaf = tree["layers"]
            for k in parts[2:]:
                leaf = leaf[k]
            want = np.asarray(leaf[int(parts[1])], np.float32)
        else:
            leaf = tree
            for k in parts:
                leaf = leaf[k]
            want = np.asarray(leaf, np.float32)
        got = state[name]
        assert got.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(got.float().numpy(), want,
                                      err_msg=name)


def test_drawn_leaves_have_the_reference_scales():
    _, tcfg = _reduced(FALCON, d_model=256, **F32)
    m = zoo.init_model(tcfg, 0, device="cpu").layers[0].mamba
    assert abs(float(m.conv_w.std()) - 0.1) < 0.01
    assert abs(float(m.in_proj.w.std()) - 256 ** -0.5) < 2e-3


def test_xla_log_and_linspace_bit_for_bit():
    """The leaves' formulas against XLA on the CPU: the f32 log over
    100,000 random positive values and the integers 1..256, and
    ``jnp.linspace(1, 16, H)`` for every H up to 352."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(1e-3, 1e4, 100_000),
                        np.arange(1, 257)]).astype(np.float32)
    np.testing.assert_array_equal(ssm._xla_log_f32(x),
                                  np.asarray(jnp.log(jnp.asarray(x))))
    for H in range(1, 353):
        np.testing.assert_array_equal(
            ssm._jnp_linspace_f32(1.0, 16.0, H),
            np.asarray(jnp.linspace(1.0, 16.0, H)), err_msg=f"H={H}")
