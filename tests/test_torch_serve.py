"""The port's LM serving slice (``repro_torch.serve``) against the JAX
reference's, as a whole: ``greedy_generate``, the prefill and decode steps
and the ``ContinuousBatcher`` on the same weights (carried across by
``params_from_numpy``) and the same prompts, made with numpy from a seed;
a narrow smollm, and reduced falcon-mamba-7b and zamba2-1.2b, whose
batcher resets the SSM state at each wave where the reference carries it
over.

In f32 the two packages differ only in summation order, so greedy tokens
must be equal and logits within 1e-4.  In bf16 (the serving dtype) logits
are held at the reference's bf16 tolerance (atol 0.15, rtol 0.05)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, make_serve_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import zoo as jax_zoo
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro.serve.serve_step import greedy_generate as jax_greedy_generate
from repro.serve.serve_step import make_decode_step as jax_make_decode_step
from repro.serve.serve_step import make_prefill_step as jax_make_prefill_step
from repro_torch.configs.base import get_config as port_get_config
from repro_torch.configs.base import \
    make_serve_config as port_make_serve_config
from repro_torch.configs.base import reduce_config as port_reduce_config
from repro_torch.models import Model, init_model, params_from_numpy
from repro_torch.serve import (ContinuousBatcher, greedy_generate,
                               make_decode_step, make_prefill_step)

#: the narrow smollm of examples/continuous_batching.py
EXAMPLE = dict(n_layers=4, d_model=192, n_heads=6, n_kv_heads=3, head_dim=32,
               d_ff=512, vocab=2048)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def serve_configs(**kw):
    jcfg = make_serve_config(dataclasses.replace(get_config("smollm-135m"),
                                                 **EXAMPLE), model_axis=1)
    tcfg = port_make_serve_config(
        dataclasses.replace(port_get_config("smollm-135m"), **EXAMPLE),
        model_axis=1)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


@pytest.fixture(scope="module")
def f32_pair():
    jcfg, tcfg = serve_configs(**F32)
    params = jax_zoo.init_model(jcfg, jax.random.key(0))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jcfg, tcfg, params, model


def test_greedy_generate_matches_reference_in_f32(f32_pair):
    jcfg, tcfg, params, model = f32_pair
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 21))
    want = jax_greedy_generate(params, jcfg, jnp.asarray(prompt, jnp.int32),
                               max_new=12)
    got = greedy_generate(model, tcfg, prompt, max_new=12, device="cpu")
    assert got.shape == (3, 12) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_decode_steps_match_reference(f32_pair):
    jcfg, tcfg, params, model = f32_pair
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 30))
    jl, jc = jax_make_prefill_step(jcfg, 40)(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tl, tc = make_prefill_step(tcfg, 40, device="cpu")(
        model, {"tokens": prompt})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
    jl, jc = jax_make_decode_step(jcfg)(
        params, jc, {"tokens": jnp.asarray(nxt, jnp.int32)}, jnp.int32(30))
    tl, tc = make_decode_step(tcfg, device="cpu")(
        model, tc, {"tokens": nxt}, 30)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tc["layers"]["v"].numpy(),
                               np.asarray(jc["layers"]["v"]), atol=1e-4)


def _submit_example(batcher, vocab):
    """The requests of examples/continuous_batching.py."""
    rng = np.random.default_rng(0)
    for _ in range(10):
        plen = int(rng.integers(8, 24))
        batcher.submit(rng.integers(0, vocab, plen).astype(np.int32),
                       max_new=int(rng.integers(8, 20)))


def test_continuous_batcher_matches_reference(f32_pair):
    jcfg, tcfg, params, model = f32_pair
    jb = JaxBatcher(jcfg, params, slots=4, max_len=128)
    tb = ContinuousBatcher(tcfg, model, slots=4, max_len=128, device="cpu")
    _submit_example(jb, jcfg.vocab)
    _submit_example(tb, tcfg.vocab)
    js, ts = jb.run_until_drained(), tb.run_until_drained()
    assert set(ts) == set(js)
    for k in ("requests", "ticks", "tokens"):
        assert ts[k] == js[k], k
    assert ts["requests"] == 10
    assert tb.caches["layers"]["k"].device.type == "cpu"
    want = {r.rid: r.out_tokens for r in jb.finished}
    got = {r.rid: r.out_tokens for r in tb.finished}
    assert got == want


def test_batcher_left_pads_with_token_zero(f32_pair):
    """A wave's prompts are left-padded with token 0, which is attended like
    any token (as in the reference): a short prompt served beside a long one
    equals the same prompt served alone with explicit leading zeros."""
    _, tcfg, _, model = f32_pair
    rng = np.random.default_rng(3)
    short, long_ = (rng.integers(1, tcfg.vocab, n).astype(np.int32)
                    for n in (5, 12))
    pair = ContinuousBatcher(tcfg, model, slots=2, max_len=64, device="cpu")
    pair.submit(short, max_new=6)
    pair.submit(long_, max_new=6)
    pair.run_until_drained()
    alone = ContinuousBatcher(tcfg, model, slots=1, max_len=64, device="cpu")
    alone.submit(np.concatenate([np.zeros(7, np.int32), short]), max_new=6)
    alone.run_until_drained()
    assert pair.finished[0].rid == 0
    assert pair.finished[0].out_tokens == alone.finished[0].out_tokens


def test_bf16_serving_tracks_reference():
    jcfg, tcfg = serve_configs()  # bf16 params and compute, as served
    params = jax_zoo.init_model(jcfg, jax.random.key(4))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    assert model.embed.table.dtype == torch.bfloat16
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 33))
    jl, _ = jax_make_prefill_step(jcfg, 40)(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tl, _ = make_prefill_step(tcfg, 40, device="cpu")(
        model, {"tokens": prompt})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.15,
                               rtol=0.05)


def test_entry_points_default_to_cuda():
    _, tcfg = serve_configs(**F32)
    if torch.cuda.is_available():
        model = init_model(tcfg, 0)
        assert model.device.type == "cuda"
        out = greedy_generate(model, tcfg, np.zeros((1, 4), np.int64),
                              max_new=2)
        assert out.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(tcfg, 0)
    model = init_model(tcfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        greedy_generate(model, tcfg, np.zeros((1, 4), np.int64), max_new=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatcher(tcfg, model)
    with pytest.raises(RuntimeError, match="cuda"):
        make_prefill_step(tcfg, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        make_decode_step(tcfg)


def test_model_on_another_device_is_refused():
    _, tcfg = serve_configs(**F32)
    model = Model(tcfg, device="meta")
    with pytest.raises(ValueError, match="model is on meta"):
        greedy_generate(model, tcfg, np.zeros((1, 4), np.int64), max_new=2,
                        device="cpu")


# ------------------------------------------------- SSM and hybrid families
@pytest.fixture(scope="module", params=["falcon-mamba-7b", "zamba2-1.2b"])
def ssm_pair(request):
    """Reduced falcon-mamba-7b (Mamba-1) or zamba2-1.2b (Mamba-2 and the
    shared attention block) as served, in f32, on the reference's
    weights."""
    jcfg = dataclasses.replace(make_serve_config(
        jax_reduce_config(get_config(request.param)), 1), **F32)
    tcfg = dataclasses.replace(port_make_serve_config(
        port_reduce_config(port_get_config(request.param)), 1), **F32)
    params = jax_zoo.init_model(jcfg, jax.random.key(5))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jcfg, tcfg, params, model


def test_ssm_greedy_generate_matches_reference_in_f32(ssm_pair):
    jcfg, tcfg, params, model = ssm_pair
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, (3, 21))
    want = jax_greedy_generate(params, jcfg, jnp.asarray(prompt, jnp.int32),
                               max_new=12)
    got = greedy_generate(model, tcfg, prompt, max_new=12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _two_waves(batcher, vocab, only_second=False):
    """Six requests for three slots, two waves; request 3 repeats request
    0, and both are the longest prompt of their wave, so neither is
    padded.  The prompts are short: a state carried into a prompt decays
    with every token of it (by exp(dt A) per step, A <= -1)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, vocab, n).astype(np.int32)
               for n in (3, 2, 3, 0, 1, 2)]
    prompts[3] = prompts[0]
    news = (8, 6, 7, 8, 5, 6)
    first = 3 if only_second else 0
    for prompt, new in list(zip(prompts, news))[first:]:
        batcher.submit(prompt, max_new=new)
    return batcher


def _tokens_by_rid(batcher) -> dict:
    return {r.rid: r.out_tokens for r in batcher.finished}


def test_ssm_batcher_resets_the_state_at_each_wave(ssm_pair):
    """The first wave equals the reference's token for token.  The
    reference's second wave starts from the first wave's final SSM state,
    so its repeat of request 0 gets other tokens; the port zeroes the
    state at admission, so its repeat equals request 0, and its second
    wave equals the reference serving those requests on fresh caches."""
    jcfg, tcfg, params, model = ssm_pair
    jb = _two_waves(JaxBatcher(jcfg, params, slots=3, max_len=40),
                    jcfg.vocab)
    tb = _two_waves(ContinuousBatcher(tcfg, model, slots=3, max_len=40,
                                      device="cpu"), tcfg.vocab)
    js, ts = jb.run_until_drained(), tb.run_until_drained()
    assert ts["requests"] == js["requests"] == 6
    want, got = _tokens_by_rid(jb), _tokens_by_rid(tb)
    assert [got[i] for i in range(3)] == [want[i] for i in range(3)]
    assert got[3] == got[0]
    assert want[3] != want[0]  # the reference carries the state over
    fresh = _two_waves(JaxBatcher(jcfg, params, slots=3, max_len=40),
                       jcfg.vocab, only_second=True)
    fresh.run_until_drained()
    assert [got[i] for i in range(3, 6)] == [
        _tokens_by_rid(fresh)[i] for i in range(3)]
