"""The SSM, hybrid, encoder-decoder and VLM families on meshes past 1x1,
on the CPU (gloo), held against the reference.

As ``tests/test_torch_distributed.py``: the test computes the reference's
side here (JAX, one device) on inputs made with numpy from a seed and
writes them to ``in.npz``; one world of 4 ``tests/_torch_dist_worker.py``
ranks (torch only) runs the cases ``families_train`` and
``families_serve`` once for the module.

The four families at ``reduce_config`` widths in f32, weights carried
from the reference (``models/convert.py``):

- 2x2, FSDP + tensor parallelism (``train``) and ``dp_train``: the loss
  within rtol 1e-5 of the reference's ``zoo.loss_fn`` and every gradient
  leaf within 1e-4 of its largest value against ``jax.grad`` (zamba2's
  reference with ``tests/_torch_ssd.py``'s decay: its own Mamba-2 gradient
  is NaN), one whole ``make_train_step``'s loss, each parameter's
  placement equal to the reference's ``param_pspec``;
- 1x4, ``serve`` under ``choose_serve_cache_policy``: a prefill and
  teacher-forced decode steps' logits within 1e-3 of the reference's
  unsharded ``decode_step``, greedy tokens (``greedy_generate``) >= 99 %
  the reference's, the parameters' and caches' placements the
  reference's ``param_pspec`` / ``cache_pspec``, and the SSM and hybrid
  batchers' two waves sharded as unsharded;
- bf16 (``tests/_torch_bf16.py``, whose docstring gives the bounds and
  the noise floor they are held beyond): a second world of 4 runs
  falcon-mamba-7b (SSM) and zamba2-1.2b (hybrid) at bf16 compute, FSDP +
  TP on 2x2 (loss and every gradient leaf) and serving on 1x4 (greedy
  tokens, free-running and teacher-forced), against the reference's own
  bf16 schedule on the same mesh (``tests/_jax_mesh_worker.py``) and the
  port's one-device bf16 run;
- on both meshes, a leaf of each new schedule computed from this rank's
  chunk (Mamba-1 ``in_proj``'s chunk of each half, Mamba-2 ``in_x``, the
  shared block's ``wq``, cross-attention's ``wq``, the projector's
  ``fc1``), and internvl2's attention whole where its single KV head does
  not divide the model axis while its MLP still splits.
"""
import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import make_serve_config as jax_make_serve_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.distributed import sharding as jax_sharding
from repro.models import ssm as jax_ssm
from repro.models import zoo as jax_zoo
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro.utils.tree import flatten_names

import _torch_bf16 as bf16
import _torch_dist_worker as worker
import _torch_families as families
from _torch_ssd import segsum_decay_masked_first
from test_torch_distributed import (BF16_TIMEOUT_S, SEP, _flat, _run_world,
                                    bf16_inputs, check_bf16_gradients,
                                    check_bf16_tokens, finish_bf16,
                                    start_bf16)

ARCHS = ("falcon-mamba-7b", "zamba2-1.2b", "seamless-m4t-medium",
         "internvl2-26b")
MODES = ("train", "dp_train")
TRAIN_B, TRAIN_S = 4, 32
SERVE_B, SERVE_S, SERVE_IMG, NEW = 4, 8, 8, 4
WORLD = 4
WORLD_TIMEOUT_S = 240
TRAIN_MESH = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                   axis_names=("data", "model"))
SERVE_MESH = types.SimpleNamespace(shape={"data": 1, "model": 4},
                                   axis_names=("data", "model"))
STACKS = ("layers", "enc_layers", "dec_layers")


def _cfg(arch):
    return dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                               param_dtype="float32", compute_dtype="float32")


def _serve_cfg(arch):
    cfg = jax_make_serve_config(_cfg(arch), SERVE_MESH.shape["model"])
    return dataclasses.replace(
        cfg, param_dtype="float32",
        **jax_sharding.choose_serve_cache_policy(cfg, SERVE_MESH))


def _port_names(name: str, value) -> list:
    """(port name, value) of a reference leaf: a stacked leaf once per
    layer (``layers/mamba/in_proj/w`` -> ``layers.<i>.mamba.in_proj.w``)."""
    stack, _, rest = name.partition("/")
    if stack in STACKS:
        return [(f"{stack}.{i}.{rest.replace('/', '.')}", v)
                for i, v in enumerate(value)]
    return [(name.replace("/", "."), value)]


def _expected_placements(spec, axis_names, stacked: bool) -> list:
    """The DTensor placements' strings of a reference spec, one a mesh
    axis (a layer's spec without its stacked leading entry)."""
    entries = list(spec)[1:] if stacked else list(spec)
    out = []
    for axis in axis_names:
        dims = [d for d, e in enumerate(entries) if e is not None and axis in (
            e if isinstance(e, tuple) else (e,))]
        out.append(f"S({dims[0]})" if dims else "R")
    return out


def _param_placements(params, cfg, mesh, mode) -> dict:
    out = {}
    for name, leaf in flatten_names(params):
        spec = jax_sharding.param_pspec(name, leaf, cfg, mesh, mode=mode)
        want = _expected_placements(spec, mesh.axis_names,
                                    name.split("/")[0] in STACKS)
        for port, _ in _port_names(name, leaf):
            out[port] = want
    return out


def _reference_train(arch, params, batch):
    cfg = _cfg(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        if cfg.family == "hybrid":
            mp.setattr(jax_ssm, "_segsum_decay", segsum_decay_masked_first)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_zoo.loss_fn(p, cfg, jb)[0]))(params)
    out = {}
    for name, g in flatten_names(grads):
        out.update(_port_names(name, np.asarray(g, np.float32)))
    return float(loss), out


def _reference_serve(arch, params, serve_in):
    """The prefill's and greedy decode steps' logits and tokens, unsharded;
    and the greedy tokens of the text prompt alone (``greedy_generate``)."""
    cfg = _serve_cfg(arch)
    prompt = jnp.asarray(serve_in["prompt"])
    first = {"tokens": prompt}
    enc = None
    if cfg.is_encdec:
        enc = jax_zoo.encode_frames(params, cfg,
                                    jnp.asarray(serve_in["frames"]))
        first["enc_out"] = enc
    if cfg.frontend == "patch":
        first["patch_embeds"] = jnp.asarray(serve_in["patch_embeds"])
    start = SERVE_S + (SERVE_IMG if cfg.frontend == "patch" else 0)
    max_len = start + NEW
    step = jax.jit(lambda p, b, c, i: jax_zoo.decode_step(
        p, cfg, b, c, cache_index=i))
    caches = jax_zoo.init_cache(cfg, SERVE_B, max_len)
    lg, caches = step(params, first, caches, jnp.int32(0))
    logits, toks = [np.asarray(lg)], [np.asarray(jnp.argmax(lg[:, -1], -1))]
    for i in range(NEW - 1):
        b = {"tokens": jnp.asarray(toks[-1])[:, None]}
        if enc is not None:
            b["enc_out"] = enc
        lg, caches = step(params, b, caches, jnp.int32(start + i))
        logits.append(np.asarray(lg))
        toks.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
    tokens = np.stack(toks, axis=1)
    greedy = tokens if cfg.frontend != "patch" else np.asarray(jax_greedy(
        params, cfg, prompt, max_new=NEW))
    cache_place = {}
    for name, leaf in flatten_names(caches):
        spec = jax_sharding.cache_pspec(name, leaf, cfg, SERVE_MESH)
        cache_place[name] = _expected_placements(spec, SERVE_MESH.axis_names,
                                                 False)
    return {"logits": np.concatenate(logits, axis=1), "tokens": tokens,
            "greedy": greedy, "cache_place": cache_place}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_families")
    rng = np.random.default_rng(0)
    inp, want = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        params = jax_zoo.init_model(cfg, jax.random.key(10 + i))
        inp.update(_flat(arch, params))
        batch = families.batch(cfg, TRAIN_B, TRAIN_S, rng)
        inp.update({f"{arch}_train_{k}": v for k, v in batch.items()})
        loss, grads = _reference_train(arch, params, batch)
        serve_in = {"prompt": rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S),
                                           dtype=np.int32)}
        if cfg.is_encdec:
            serve_in["frames"] = rng.standard_normal(
                (SERVE_B, SERVE_S // 2, cfg.d_model), dtype=np.float32)
        if cfg.frontend == "patch":
            serve_in["patch_embeds"] = rng.standard_normal(
                (SERVE_B, SERVE_IMG, cfg.frontend_dim), dtype=np.float32)
        served = _reference_serve(arch, params, serve_in)
        inp.update({f"{arch}_serve_{k}": v for k, v in serve_in.items()})
        inp[f"{arch}_serve_feed"] = served["tokens"][:, :-1]
        inp[f"{arch}_serve_waves"] = rng.integers(0, cfg.vocab, (4, 6),
                                                  dtype=np.int32)
        want[arch] = {
            "loss": loss, "grads": grads, "serve": served,
            "weights": {n: v for name, leaf in flatten_names(params)
                        for n, v in _port_names(name, np.asarray(leaf))},
            "place": {mode: _param_placements(params, cfg, TRAIN_MESH, mode)
                      for mode in MODES},
            "serve_place": _param_placements(params, _serve_cfg(arch),
                                             SERVE_MESH, "serve")}
    np.savez(d / "in.npz", **inp)
    return d, want


@pytest.fixture(scope="module")
def world(reference):
    d, want = reference
    return _run_world(d, WORLD, "families_train,families_serve",
                      timeout=WORLD_TIMEOUT_S), want


CASES = [(arch, mode) for arch in ARCHS for mode in MODES]


@pytest.mark.parametrize("arch,mode", CASES)
def test_family_loss_matches_reference(world, arch, mode):
    got, want = world
    np.testing.assert_allclose(got[f"{arch}_{mode}_loss"], want[arch]["loss"],
                               rtol=1e-5)
    if mode == "train":  # a whole step: the loss before its update
        np.testing.assert_allclose(got[f"{arch}_train_step_loss"],
                                   want[arch]["loss"], rtol=1e-5)


@pytest.mark.parametrize("arch,mode", CASES)
def test_family_gradients_match_reference(world, arch, mode):
    got, want = world
    ref = want[arch]["grads"]
    prefix = f"{arch}_{mode}_grad{SEP}"
    assert sorted(k[len(prefix):] for k in got if k.startswith(prefix)) == \
        sorted(ref)
    for name, w in ref.items():
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(got[prefix + name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("arch,mode", CASES + [(a, "serve") for a in ARCHS])
def test_family_placements_match_param_pspec(world, arch, mode):
    got, want = world
    ref = (want[arch]["serve_place"] if mode == "serve"
           else want[arch]["place"][mode])
    prefix = f"{arch}_{mode}_place{SEP}"
    assert sorted(k[len(prefix):] for k in got if k.startswith(prefix)) == \
        sorted(ref)
    for name, w in ref.items():
        assert list(got[prefix + name]) == w, name
    if mode == "serve":
        for name, w in want[arch]["serve"]["cache_place"].items():
            key = f"{arch}_serve_cache{SEP}" + name.replace("/", SEP)
            assert list(got[key]) == w, name


@pytest.mark.parametrize("arch", ARCHS)
def test_family_sharded_decode_matches_reference(world, arch):
    got, want = world
    ref = want[arch]["serve"]
    assert got[f"{arch}_serve_logits"].shape == ref["logits"].shape
    np.testing.assert_allclose(got[f"{arch}_serve_logits"], ref["logits"],
                               rtol=0, atol=1e-3)
    tokens = np.argmax(got[f"{arch}_serve_logits"], axis=-1)
    assert (tokens == ref["tokens"]).mean() >= 0.99
    assert (got[f"{arch}_serve_greedy"] == ref["greedy"]).mean() >= 0.99


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_family_batcher_sharded_as_unsharded(world, arch):
    """Two waves of 2 slots: the SSM state zeroed on each rank's block at
    the second admission, as the unsharded batcher zeroes it whole."""
    got, _ = world
    sharded, plain = got[f"{arch}_batcher"]
    assert sharded.shape == (4, NEW)
    assert (sharded == plain).mean() >= 0.99


#: (arch, leaf, how rank 0's compute tensor is taken from the whole)
LOCAL = [
    ("falcon-mamba-7b", "layers.0.mamba.in_proj", "halves"),
    ("zamba2-1.2b", "layers.0.mamba.in_x", "columns"),
    ("zamba2-1.2b", "shared_attn.attn.wq", "columns"),
    ("seamless-m4t-medium", "dec_layers.0.cross.wq", "columns"),
    ("internvl2-26b", "projector.fc1", "columns"),
    ("internvl2-26b", "layers.0.mlp.gate", "columns"),
    ("internvl2-26b", "layers.0.attn.wq", "whole"),
]


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch,leaf,how", LOCAL)
def test_family_leaf_computed_from_its_chunk(world, arch, leaf, how, mode):
    """Rank 0's compute tensor of the leaf (model rank 0): its chunk of
    the columns (of each of ``xin`` and ``z`` for Mamba-1's ``in_proj``),
    not the whole; internvl2's attention whole (one KV head: it does not
    divide the model axis), while its MLP splits."""
    got, want = world
    w = want[arch]["weights"][leaf + ".w"]
    m = (TRAIN_MESH if mode == "train" else SERVE_MESH).shape["model"]
    local = got[f"{arch}_{mode}_local{SEP}{leaf}"]
    n = w.shape[1]
    if how == "halves":
        c = n // 2 // m
        expect = np.concatenate([w[:, :c], w[:, n // 2:n // 2 + c]], axis=1)
    elif how == "columns":
        expect = w[:, :n // m]
    else:
        expect = w
    assert local.shape == expect.shape
    np.testing.assert_array_equal(local, expect)


# --------------------------------------------------------------------------
# bf16 past 1x1: the SSM and hybrid families
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bf16_runs(tmp_path_factory):
    """(the port's 4-rank runs by world size, its one-device runs, the
    reference's on the mesh and on one device)."""
    d = tmp_path_factory.mktemp("dist_families_bf16")
    bf16_inputs(d, True, {})
    deadline = time.monotonic() + BF16_TIMEOUT_S
    running = start_bf16(d, (WORLD,), True)
    one = worker.bf16_unsharded(np.load(d / "in.npz"), True)
    got, ref = finish_bf16(d, running, deadline)
    return got, one, ref


BF16_TRAIN = [c for c in bf16.TRAIN if c[1] in bf16.FAMILY_ARCHS]
BF16_SERVE = [c for c in bf16.SERVE if c[1] in bf16.FAMILY_ARCHS]


@pytest.mark.parametrize("case", BF16_TRAIN, ids=[c[0] for c in BF16_TRAIN])
def test_bf16_family_loss_matches_reference_schedule(bf16_runs, case):
    got, one, ref = bf16_runs
    tag, _, dims, _ = case
    loss = got[bf16.world_of(dims)][f"{tag}{SEP}loss"]
    np.testing.assert_allclose(loss, ref[f"{tag}{SEP}loss"],
                               rtol=bf16.LOSS_RTOL)
    np.testing.assert_allclose(loss, one[f"one{SEP}{tag}{SEP}loss"],
                               rtol=bf16.LOSS_RTOL)


@pytest.mark.parametrize("case", BF16_TRAIN, ids=[c[0] for c in BF16_TRAIN])
def test_bf16_family_gradients_match_reference_schedule(bf16_runs, case):
    check_bf16_gradients(bf16_runs, case)


@pytest.mark.parametrize("forced", [True, False], ids=["forced", "free"])
@pytest.mark.parametrize("case", BF16_SERVE, ids=[c[0] for c in BF16_SERVE])
def test_bf16_family_greedy_tokens_match_reference_schedule(bf16_runs, case,
                                                            forced):
    check_bf16_tokens(bf16_runs, case, forced)
