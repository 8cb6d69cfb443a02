"""The MoE family on the port (``repro_torch.models.moe`` and the ``moe``
blocks of ``zoo``) against the JAX reference on the CPU: the routing
helpers on the reference's own router logits, the forced-overflow drop,
the expert-sliced partial outputs, ``moe_apply``, and reduced
``qwen3-moe-30b-a3b`` and DeepSeek-V2-Lite without MLA (shared experts and
a leading dense layer) as whole models: forward, prefill then decode,
``greedy_generate``, the ``ContinuousBatcher``, the loss and every
gradient leaf; and ``_aux_load_balance_loss`` (no caller in either
package) in value and in its gradient by the logits against ``jax.grad``.
Weights are the reference's, carried across by
``params_from_numpy``; inputs are made with numpy from a seed.

Tolerances: routing exact (``idx``, ``pos``, ``cap``, ``keep``) and the
weights at rtol 1e-6; f32 outputs within 1e-5 for one MoE block and
1e-4 for a model (both frameworks compute in f32 and differ only in
summation order); greedy f32 tokens exact; the training oracle's loss
rtol 1e-5 and per-leaf gradients 1e-4 of the leaf's largest value; the
auxiliary loss rtol 1e-5 and its gradient 1e-4 of its largest value.  A
whole-model comparison first checks that no token's k-th and (k+1)-th
gates lie within ``GAP`` of each other, since the last bits of the router
logits differ between the frameworks and such a near-tie would route a
token to another expert in one of them."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import make_serve_config as jax_make_serve_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import zoo as jax_zoo
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro.serve.serve_step import greedy_generate as jax_greedy_generate
from repro_torch.configs.base import get_config, make_serve_config, \
    reduce_config
from repro_torch.models import moe, params_from_numpy, zoo
from repro_torch.serve import ContinuousBatcher, greedy_generate

QWEN, DEEPSEEK = "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
#: the smallest k-th / (k+1)-th gate gap a whole-model comparison needs
GAP = 1e-5


def _reduced(arch, **kw):
    """The reference's and the port's reduced config of ``arch``; DeepSeek
    without MLA, so these cases hold the MoE layers alone
    (``tests/test_torch_mla.py`` runs DeepSeek with MLA)."""
    if arch == DEEPSEEK:
        kw = {"mla": None, **kw}
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch)), **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


def _carried(jcfg, tcfg, seed=0):
    params = jax_zoo.init_model(jcfg, jax.random.key(seed))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return params, model


def _moe_pair(jcfg, tcfg, seed=0):
    """The first MoE layer's parameters, reference and port."""
    params, model = _carried(jcfg, tcfg, seed)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    return jp, model.layers[0].moe


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


class GateGaps:
    """Records, while active, the smallest gap between each token's k-th
    and (k+1)-th gate over every routing the port makes."""

    def __init__(self):
        self.smallest = np.inf
        self.calls = 0
        self._routing = moe._topk_routing

    def _record(self, logits, top_k):
        gates = torch.sort(torch.softmax(logits.float(), -1), -1,
                           descending=True).values
        if gates.shape[-1] > top_k:
            gap = float((gates[:, top_k - 1] - gates[:, top_k]).min()
                        .detach())
            self.smallest = min(self.smallest, gap)
        self.calls += 1
        return self._routing(logits, top_k)

    def __enter__(self):
        self._patch = mock.patch.object(moe, "_topk_routing", self._record)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def check(self):
        assert self.calls > 0
        assert self.smallest > GAP, (
            f"a token's k-th and (k+1)-th gates are {self.smallest} apart "
            f"(<= {GAP}): the comparison with the reference is not "
            f"well-posed on these inputs")


# ------------------------------------------------------------ routing helpers
ROUTING_CASES = [(8, 2, 1), (8, 2, 7), (8, 2, 80), (128, 8, 1), (128, 8, 8),
                 (128, 8, 300), (64, 6, 33)]


@pytest.mark.parametrize("n_routed,top_k,T", ROUTING_CASES)
def test_routing_helpers_match_reference(n_routed, top_k, T):
    """Fed the reference's router logits, the port's top-k, positions,
    capacity and keep mask equal the reference's."""
    jcfg, tcfg = _reduced(QWEN, **F32)
    m = dataclasses.replace(jcfg.moe, n_routed=n_routed, top_k=top_k)
    jcfg = dataclasses.replace(jcfg, moe=m)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, n_routed=n_routed, top_k=top_k))
    rng = np.random.default_rng(T * 1000 + n_routed)
    x = rng.standard_normal((T, jcfg.d_model), dtype=np.float32)
    router = jax_layers.init_dense(jax.random.key(T), jcfg.d_model, n_routed)
    logits = np.asarray(jax_layers.dense_apply(router, jnp.asarray(x),
                                               jnp.float32))
    jw, jidx = jax_moe._topk_routing(jnp.asarray(logits), top_k)
    jpos = jax_moe._positions_in_expert(jidx, n_routed)
    jcap = max(int(np.ceil(m.top_k * T * m.capacity_factor / m.n_routed)), 1)
    jkeep = np.asarray(jpos) < jcap

    logits = np.array(logits)
    plan = moe.route(torch.from_numpy(logits), tcfg)
    np.testing.assert_array_equal(plan["idx"].numpy(), np.asarray(jidx))
    np.testing.assert_allclose(plan["weights"].numpy(), np.asarray(jw),
                               rtol=1e-6)
    np.testing.assert_array_equal(plan["pos"].numpy(), np.asarray(jpos))
    assert plan["cap"] == jcap == moe.capacity(tcfg.moe, T)
    np.testing.assert_array_equal(plan["keep"].numpy(), jkeep)
    w, idx = moe._topk_routing(torch.from_numpy(logits), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        moe._positions_in_expert(idx, n_routed).numpy(), np.asarray(jpos))


def test_topk_ties_take_the_lower_expert_first():
    """Equal gates: the lower expert index comes first, as in
    ``jax.lax.top_k``."""
    logits = np.zeros((3, 16), np.float32)
    logits[0, 5] = 2.0
    logits[1, [3, 9, 12]] = 1.0
    jw, jidx = jax_moe._topk_routing(jnp.asarray(logits), 4)
    w, idx = moe._topk_routing(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy()[1], [3, 9, 12, 0])
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_forced_overflow_drops_what_the_reference_drops():
    """A router that sends every token to expert 0 first (the other gates
    all equal, so slots 1..k-1 go to experts 1..k-1): each of those
    experts gets all T tokens and keeps the first ``cap``."""
    jcfg, tcfg = _reduced(QWEN, **F32)
    jp, tp = _moe_pair(jcfg, tcfg)
    d, E, k = jcfg.d_model, jcfg.moe.n_routed, jcfg.moe.top_k
    w = np.zeros((d, E), np.float32)
    w[0, 0] = 3.0
    jp = dict(jp, router={"w": jnp.asarray(w)})
    tp.router.w.data = torch.from_numpy(w)
    T = 40
    x = np.random.default_rng(0).standard_normal((T, d), dtype=np.float32)
    x[:, 0] = 1.0
    logits = torch.from_numpy(x) @ tp.router.w
    plan = moe.route(logits, tcfg)
    cap = moe.capacity(tcfg.moe, T)
    assert cap < T
    np.testing.assert_array_equal(plan["idx"].numpy(),
                                  np.tile(np.arange(k), (T, 1)))
    want_keep = np.zeros((T, k), bool)
    want_keep[:cap] = True
    np.testing.assert_array_equal(plan["keep"].numpy(), want_keep)
    want = jax_moe.moe_ffn_local(jp, jnp.asarray(x), jcfg)
    got = moe.moe_ffn_local(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)
    # the dropped tokens get nothing from the routed experts
    assert np.all(np32(got)[cap:] == 0) and np.any(np32(got)[:cap] != 0)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_expert_slices_sum_to_the_whole(n_shards):
    """Each shard's partial output (``expert_slice`` with that shard's
    weights) equals the reference's, and the partials sum to the whole."""
    jcfg, tcfg = _reduced(QWEN, **F32)
    jp, tp = _moe_pair(jcfg, tcfg, seed=1)
    E = tcfg.moe.n_routed
    e_per = E // n_shards
    x = np.random.default_rng(2).standard_normal((50, tcfg.d_model),
                                                 dtype=np.float32)
    whole = moe.moe_ffn_local(tp, torch.from_numpy(x), tcfg)
    total = torch.zeros_like(whole)
    for s in range(n_shards):
        cut = slice(s * e_per, (s + 1) * e_per)
        part = mock.Mock(router=tp.router, w_gate=tp.w_gate[cut],
                         w_up=tp.w_up[cut], w_down=tp.w_down[cut])
        got = moe.moe_ffn_local(part, torch.from_numpy(x), tcfg,
                                expert_slice=(s * e_per, e_per))
        jpart = dict(jp, w_gate=jp["w_gate"][cut], w_up=jp["w_up"][cut],
                     w_down=jp["w_down"][cut])
        want = jax_moe.moe_ffn_local(jpart, jnp.asarray(x), jcfg,
                                     expert_slice=(s * e_per, e_per))
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)
        total += got
    np.testing.assert_allclose(np32(total), np32(whole), atol=1e-5)


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
@pytest.mark.parametrize("capacity_factor", [1.25, 100.0])
def test_moe_apply_matches_reference_in_f32(arch, capacity_factor):
    jcfg, tcfg = _reduced(arch, **F32)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity_factor))
    jp, tp = _moe_pair(jcfg, tcfg, seed=3)
    assert (tp.shared is not None) == (arch == DEEPSEEK)
    x = np.random.default_rng(4).standard_normal((3, 20, tcfg.d_model),
                                                 dtype=np.float32)
    with GateGaps() as gaps:
        got = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    gaps.check()
    want = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)


def test_moe_apply_bf16_tracks_reference():
    jcfg, tcfg = _reduced(QWEN, param_dtype="bfloat16",
                          compute_dtype="bfloat16")
    jp, tp = _moe_pair(jcfg, tcfg, seed=5)
    x = np.random.default_rng(6).standard_normal((2, 16, tcfg.d_model),
                                                 dtype=np.float32)
    got = moe.moe_apply(tp, torch.from_numpy(x).bfloat16(), tcfg)
    want = jax_moe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), atol=0.15, rtol=0.05)


# ------------------------------------------------------ the auxiliary loss
AUX_CASES = [(16, 8, 2, "float32"), (64, 128, 8, "float32"),
             (33, 60, 4, "float32"), (1, 4, 1, "float32"),
             (40, 16, 2, "bfloat16")]


@pytest.mark.parametrize("T,E,k,dtype", AUX_CASES)
def test_aux_load_balance_loss_matches_reference(T, E, k, dtype):
    """Value within rtol 1e-5 and the f32 gradient by the logits within
    1e-4 of its largest value, on the reference's own top-k choices of the
    same logits.  bf16 logits (the same bf16 values in both; the loss is
    taken in f32): the value, and a bf16 gradient."""
    logits = np.random.default_rng(T * E + k).standard_normal(
        (T, E), dtype=np.float32) * 3
    jl = jnp.asarray(logits, jnp.dtype(dtype))
    idx = np.asarray(jax.lax.top_k(jl.astype(jnp.float32), k)[1])
    want, jgrad = jax.value_and_grad(
        lambda x: jax_moe._aux_load_balance_loss(x, jnp.asarray(idx), E))(jl)
    tl = torch.from_numpy(np.asarray(jl, np.float32)).to(
        getattr(torch, dtype)).requires_grad_(True)
    got = moe._aux_load_balance_loss(tl, torch.from_numpy(idx), E)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    (tgrad,) = torch.autograd.grad(got, tl)
    assert tgrad.dtype == tl.dtype and str(jgrad.dtype) == dtype
    if dtype == "float32":
        jg, tg = np32(jgrad), tgrad.numpy()
        np.testing.assert_allclose(tg, jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max())


def test_aux_load_balance_loss_counts_as_the_reference_scatters():
    """Indices as the reference's scatter-add takes them: a negative one
    counts from the end, one out of range is dropped; a balanced routing
    gives 1 at uniform probabilities."""
    E = 8
    logits = np.zeros((4, E), np.float32)
    for idx in (np.array([[0, 1], [2, 3], [4, 5], [6, 7]]),
                np.array([[-1, 0], [9, 3], [-8, 2], [7, 8]])):
        want = jax_moe._aux_load_balance_loss(jnp.asarray(logits),
                                              jnp.asarray(idx), E)
        got = moe._aux_load_balance_loss(torch.from_numpy(logits),
                                         torch.from_numpy(idx), E)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(moe._aux_load_balance_loss(
        torch.from_numpy(logits), torch.arange(8).reshape(4, 2), E)) == 1.0


# ---------------------------------------------------------------- the models
@pytest.fixture(scope="module", params=[QWEN, DEEPSEEK])
def pair(request):
    jcfg, tcfg = _reduced(request.param, **F32)
    params, model = _carried(jcfg, tcfg)
    return jcfg, tcfg, params, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def test_model_layout(pair):
    jcfg, tcfg, params, model = pair
    n_dense = tcfg.moe.first_dense_layers
    assert (model.dense_layers is not None) == (tcfg.name.startswith(
        "deepseek"))
    assert len(model.layers) == tcfg.n_layers - n_dense
    if n_dense:
        assert len(model.dense_layers) == n_dense
        assert model.dense_layers[0].mlp.gate.w.shape[1] == \
            tcfg.moe.d_first_dense_ff
    assert model.layers[0].moe.w_down.shape == (
        tcfg.moe.n_routed, tcfg.moe.d_expert_ff, tcfg.d_model)
    caches = zoo.init_cache(tcfg, 2, 16, device="cpu")
    jcaches = jax_zoo.init_cache(jcfg, 2, 16)
    assert set(caches) == set(jcaches)
    for key in caches:
        for n in caches[key]:
            assert tuple(caches[key][n].shape) == jcaches[key][n].shape


def test_forward_matches_reference(pair):
    jcfg, tcfg, params, model = pair
    t = _tokens(jcfg, 2, 40, seed=0)
    with GateGaps() as gaps:
        got = zoo.forward(model, tcfg, {"tokens": torch.from_numpy(t)})
    gaps.check()
    want = jax_zoo.forward(params, jcfg, {"tokens": jnp.asarray(t, jnp.int32)},
                           remat=False)
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-4)


def test_prefill_then_decode_matches_reference(pair):
    jcfg, tcfg, params, model = pair
    B, S, max_len = 2, 24, 32
    t = _tokens(jcfg, B, S, seed=1)
    nxt = _tokens(jcfg, 3 * B, 1, seed=2).reshape(3, B, 1)
    jc = jax_zoo.init_cache(jcfg, B, max_len)
    tc = zoo.init_cache(tcfg, B, max_len, device="cpu")
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
            assert got.shape == (B, 1, tcfg.vocab)
            np.testing.assert_allclose(np32(got), np32(want), atol=1e-4)
    gaps.check()
    for key in tc:
        np.testing.assert_allclose(np32(tc[key]["k"]), np32(jc[key]["k"]),
                                   atol=1e-4)


def test_greedy_generate_matches_reference(pair):
    jcfg, tcfg, params, model = pair
    prompt = _tokens(jcfg, 3, 17, seed=3)
    with GateGaps() as gaps:
        got = greedy_generate(model, tcfg, prompt, max_new=10, device="cpu")
    gaps.check()
    want = jax_greedy_generate(params, jcfg, jnp.asarray(prompt, jnp.int32),
                               max_new=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _submit(batcher, vocab):
    rng = np.random.default_rng(4)
    for _ in range(6):
        plen = int(rng.integers(6, 20))
        batcher.submit(rng.integers(0, vocab, plen).astype(np.int32),
                       max_new=int(rng.integers(4, 12)))


def test_continuous_batcher_matches_reference(pair):
    jcfg, tcfg, params, model = pair
    jb = JaxBatcher(jcfg, params, slots=3, max_len=64)
    tb = ContinuousBatcher(tcfg, model, slots=3, max_len=64, device="cpu")
    _submit(jb, jcfg.vocab)
    _submit(tb, tcfg.vocab)
    with GateGaps() as gaps:
        ts = tb.run_until_drained()
    gaps.check()
    js = jb.run_until_drained()
    for k in ("requests", "ticks", "tokens"):
        assert ts[k] == js[k], k
    assert ts["requests"] == 6
    assert ({r.rid: r.out_tokens for r in tb.finished}
            == {r.rid: r.out_tokens for r in jb.finished})


def test_bf16_serving_tracks_reference():
    """bf16 serving configs (``make_serve_config``) of reduced qwen3: the
    prefill's logits at the reference's bf16 tolerance."""
    jcfg = jax_make_serve_config(jax_reduce_config(jax_get_config(QWEN)), 1)
    tcfg = make_serve_config(reduce_config(get_config(QWEN)), 1)
    params, model = _carried(jcfg, tcfg, seed=4)
    assert model.layers[0].moe.w_gate.dtype == torch.bfloat16
    prompt = _tokens(jcfg, 2, 33, seed=5)
    want, _ = jax_zoo.decode_step(params, jcfg,
                                  {"tokens": jnp.asarray(prompt, jnp.int32)},
                                  jax_zoo.init_cache(jcfg, 2, 40),
                                  cache_index=jnp.int32(0))
    got, _ = zoo.decode_step(model, tcfg, {"tokens": torch.from_numpy(prompt)},
                             zoo.init_cache(tcfg, 2, 40, device="cpu"),
                             cache_index=0)
    np.testing.assert_allclose(np32(got), np32(want), atol=0.15, rtol=0.05)


# ------------------------------------------------------------------ training
def _batch(vocab, b=2, s=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


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


def test_loss_and_gradients_match_reference(pair):
    jcfg, tcfg, params, model = pair
    # seed 6 put one qwen3 token's 2nd and 3rd gates 7.0e-6 apart (under
    # GAP); the comparison passed there too, but is not well-posed
    batch = _batch(jcfg.vocab, seed=7)
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
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = dict(zip(named, grads))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np32(g), w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


# ------------------------------------------------------------- full width
def test_full_width_param_counts_equal_reference():
    jcfg, tcfg = jax_get_config(QWEN), get_config(QWEN)
    total = zoo.analytic_param_count(tcfg)
    active = zoo.analytic_param_count(tcfg, active_only=True)
    assert total == jax_zoo.analytic_param_count(jcfg) == 30_532_122_624
    assert active == jax_zoo.analytic_param_count(jcfg, active_only=True) \
        == 3_353_032_704
    assert tcfg.param_count() == total and tcfg.active_param_count() == active


def test_full_width_model_on_meta():
    """Full-width qwen3 builds on ``meta`` with the reference's shapes."""
    cfg = make_serve_config(get_config(QWEN), 1)
    model = zoo.Model(cfg, device="meta")
    assert len(model.layers) == 48 and model.dense_layers is None
    m = model.layers[0].moe
    assert tuple(m.w_gate.shape) == (128, 2048, 768)
    assert tuple(m.router.w.shape) == (2048, 128)
    assert m.w_up.dtype == torch.bfloat16
    assert model.lm_head is not None
    jshapes = jax.eval_shape(lambda: jax_zoo.init_model(
        jax_make_serve_config(jax_get_config(QWEN), 1), jax.random.key(0)))
    assert tuple(jshapes["layers"]["moe"]["w_down"].shape) == (
        48,) + tuple(m.w_down.shape)
