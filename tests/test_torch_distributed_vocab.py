"""The vocabulary and MLA's heads split over ``model``, and the dry run's
count of collectives, on gloo worlds of the CPU, held against the
reference.

As ``tests/test_torch_distributed.py``: the test makes the inputs with
numpy from a seed and the reference's weights, writes them to ``in.npz``
and starts ``tests/_torch_dist_worker.py`` (torch only) in a world of 8
ranks (2x4), one of 4, and one ``fake`` world's rank 0 in one process;
it computes the reference's side here (JAX, one device) while they run.

- Training, FSDP + TP on 2x4 and 2x2, f32, weights carried from the
  reference: reduced smollm-135m (tied embeddings: the table is the
  head), reduced qwen2-72b (its own ``lm_head``) and reduced DeepSeek
  (MLA over this rank's heads, the MoE without drops).  The loss within
  rtol 1e-5 of the reference's unsharded ``zoo.loss_fn`` and every
  gradient leaf within 1e-4 of its largest value against ``jax.grad`` (the
  training oracle), and the compute tensors a rank's rows of the
  vocabulary and its heads of MLA.
- Serving on 1x4, f32: ``greedy_generate``'s tokens and the batcher's
  (two waves) equal to the reference's unsharded ``greedy_generate`` and
  ``ContinuousBatcher`` (the argmax over every rank's vocabulary columns,
  the first maximum kept).
- Rank 0's collectives (kind, group size, result bytes), as
  ``launch.analytic_cost.StepCount`` logs them, of a reduced dense train
  step in both policies, a prefill and decode step with the cache placed
  by sequence and a reduced DeepSeek train step: on the gloo world's real
  tensors and in the fake world's walk on ``meta`` (where the walk's cache
  answers repeated ops), op for op and byte for byte the same.
"""
import dataclasses
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import make_serve_config as jax_make_serve_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.models import zoo as jax_zoo
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro.serve.serve_step import greedy_generate as jax_greedy
from repro.utils.tree import flatten_names

import _torch_dist_worker as worker
from test_torch_distributed import SEP, WORKER, _env, _flat

TRAIN_B, TRAIN_S = 8, 16
SERVE_B, SERVE_S = 4, 8
STACKS = ("layers", "dense_layers")
WORLD_TIMEOUT_S = 240
MESHES = ("2x4", "2x2")


def _cfg(arch):
    cfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch)),
                              param_dtype="float32", compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=100.0))
    return cfg


def _serve_cfg(arch):
    return dataclasses.replace(jax_make_serve_config(_cfg(arch), 4),
                               param_dtype="float32")


def _port_grads(grads) -> dict:
    """The reference's gradient tree by the port's names (a stacked leaf
    once per layer)."""
    out = {}
    for name, g in flatten_names(grads):
        g = np.asarray(g, np.float32)
        stack, _, rest = name.partition("/")
        if stack in STACKS:
            for i, gi in enumerate(g):
                out[f"{stack}.{i}.{rest.replace('/', '.')}"] = gi
        else:
            out[name.replace("/", ".")] = g
    return out


#: (argument, output file, cases) of each run of the worker
RUNS = {"2x4": (["8"], "out_8.npz", "vocab_train,collectives"),
        "2x2": (["4"], "out_4.npz", "vocab_train,vocab_serve"),
        "fake": (["fake", "8"], "out_fake8.npz", "collectives")}


def _start(d, args, cases) -> list:
    """The worker's processes of one run: every rank of a gloo world, or
    the one process of a fake world."""
    if args[0] == "fake":
        ranks = [args + [str(d), cases]]
    else:
        ranks = [args + [str(r), str(d), cases] for r in range(int(args[0]))]
    return [subprocess.Popen([sys.executable, str(WORKER)] + a,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=_env())
            for a in ranks]


def _finish(d, name, procs, deadline) -> dict:
    """The run's rank 0 results, or a failure with every rank's output
    (past the deadline, a failure too)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {name} run passed {WORLD_TIMEOUT_S} s")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"{name} failed {bad}:\n" + "\n".join(logs)[-6000:]
    return dict(np.load(d / RUNS[name][1]))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's runs (rank 0 of each) and the reference's results: the
    inputs are written first, the runs started, and the reference computed
    while they run."""
    d = tmp_path_factory.mktemp("dist_vocab")
    rng = np.random.default_rng(0)
    inp, want, params = {}, {}, {}
    for i, arch in enumerate(worker.VOCAB_ARCHS):
        cfg = _cfg(arch)
        params[arch] = jax_zoo.init_model(cfg, jax.random.key(20 + i))
        inp.update(_flat(arch, params[arch]))
        toks = rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1),
                            dtype=np.int32)
        inp.update({f"{arch}_train_tokens": toks[:, :-1],
                    f"{arch}_train_targets": toks[:, 1:]})
        if arch in worker.VOCAB_SERVE_ARCHS:
            inp[f"{arch}_prompt"] = rng.integers(
                0, cfg.vocab, (SERVE_B, SERVE_S), dtype=np.int32)
            inp[f"{arch}_waves"] = rng.integers(0, cfg.vocab, (4, 6),
                                                dtype=np.int32)
    np.savez(d / "in.npz", **inp)
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    running = {name: _start(d, args, cases)
               for name, (args, _, cases) in RUNS.items()}
    for arch in worker.VOCAB_ARCHS:
        cfg, p = _cfg(arch), params[arch]
        jb = {k: jnp.asarray(inp[f"{arch}_train_{k}"])
              for k in ("tokens", "targets")}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda pp, cfg=cfg: jax_zoo.loss_fn(pp, cfg, jb)[0]))(p)
        want[arch] = {"loss": float(loss), "grads": _port_grads(grads)}
        if arch not in worker.VOCAB_SERVE_ARCHS:
            continue
        scfg = _serve_cfg(arch)
        want[arch]["greedy"] = np.asarray(jax_greedy(
            p, scfg, jnp.asarray(inp[f"{arch}_prompt"]),
            max_new=worker.VOCAB_NEW))
        batcher = JaxBatcher(scfg, p, slots=2, max_len=32)
        for row in inp[f"{arch}_waves"]:
            batcher.submit(row, worker.VOCAB_NEW)
        batcher.run_until_drained()
        want[arch]["batcher"] = np.array([r.out_tokens for r in sorted(
            batcher.finished, key=lambda r: r.rid)])
    got = {name: _finish(d, name, procs, deadline)
           for name, procs in running.items()}
    return got, want


@pytest.fixture(scope="module")
def fake(worlds):
    """Rank 0 of a fake world of 8 (2x4), in one process, on ``meta``."""
    return worlds[0]["fake"]


CASES = [(arch, mesh) for arch in worker.VOCAB_ARCHS for mesh in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_vocab_parallel_loss_matches_reference(worlds, arch, mesh):
    got, want = worlds
    np.testing.assert_allclose(got[mesh][f"{arch}_{mesh}_loss"],
                               want[arch]["loss"], rtol=1e-5)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_vocab_parallel_gradients_match_reference(worlds, arch, mesh):
    got, want = worlds
    ref = want[arch]["grads"]
    prefix = f"{arch}_{mesh}_grad{SEP}"
    out = got[mesh]
    assert sorted(k[len(prefix):] for k in out if k.startswith(prefix)) == \
        sorted(ref)
    for name, w in ref.items():
        np.testing.assert_allclose(out[prefix + name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_a_rank_computes_its_vocab_rows_and_heads(worlds, arch, mesh):
    """The embedding's rows and the head's columns a rank computes with
    are its 1/M of the vocabulary; MLA's ``wkv_b`` columns and ``wo``
    rows are its heads'."""
    got, _ = worlds
    cfg = _cfg(arch)
    m = int(mesh.split("x")[1])
    want = [(cfg.vocab // m, cfg.d_model),
            (cfg.vocab // m, cfg.d_model) if cfg.tie_embeddings
            else (cfg.d_model, cfg.vocab // m)]
    if cfg.mla is not None:
        a = cfg.mla
        heads = cfg.n_heads // m
        want += [(a.kv_lora_rank, heads * (a.qk_nope_head_dim +
                                           a.v_head_dim)),
                 (heads * a.v_head_dim, cfg.d_model)]
    assert [tuple(x) for x in got[mesh][f"{arch}_{mesh}_widths"]] == want


@pytest.mark.parametrize("arch", worker.VOCAB_SERVE_ARCHS)
def test_sharded_greedy_and_batcher_tokens_match_reference(worlds, arch):
    got, want = worlds
    out = got["2x2"]  # the 4-rank world serves on 1x4
    np.testing.assert_array_equal(out[f"{arch}_greedy"],
                                  want[arch]["greedy"])
    np.testing.assert_array_equal(out[f"{arch}_batcher"],
                                  want[arch]["batcher"])
    cfg = _serve_cfg(arch)
    assert tuple(out[f"{arch}_serve_widths"][0]) == (cfg.vocab // 4,
                                                     cfg.d_model)


@pytest.mark.parametrize("tag", ["dense_train", "dense_dp_train",
                                 "seq_decode", "mla_train"])
def test_fake_walk_collectives_equal_a_gloo_run(worlds, fake, tag):
    """Op for op, byte for byte: the walk on ``meta`` (the count's cache
    answering repeated ops) logs what rank 0 of the gloo world did."""
    got, _ = worlds
    real, walked = got["2x4"][f"coll_{tag}"], fake[f"coll_{tag}"]
    assert len(real) > 0
    np.testing.assert_array_equal(walked, real)
    kinds = {worker.KINDS[k] for k in real[:, 0]}
    assert {"all-gather", "all-reduce"} <= kinds, kinds
    if tag != "seq_decode":  # FSDP: the gradients' reduce-scatter
        assert "reduce-scatter" in kinds
