"""The port's ``distributed/`` on several ranks, on the CPU (gloo), held
against the reference at the reference tests' own mesh shapes.

The test computes the reference's side here, in one process on one
device (JAX), on inputs made with numpy from a seed, and writes them to
``in.npz``; each world is a set of ``tests/_torch_dist_worker.py``
processes (torch only: they import neither JAX nor ``repro``) that join
through a ``FileStore`` under the test's temporary directory, run their
cases and write ``out_<world>.npz``.  Each world starts once per module,
and has its own timeout (``WORLD_TIMEOUT_S``), so a hang fails its tests
rather than the whole run.

Worlds and tolerances:

- 8 ranks: ring attention on 2x4 (causal and not; within 3e-5 of the
  reference's ``ring_attention_ref``, the reference test's bound);
  ``_moe_tp_psum`` on 2x4, reduced qwen3 at ``capacity_factor=100``
  (against the reference's local ``moe_apply``, 3e-2 as the reference
  test holds its own, and in f32 against the port's local schedule at
  1e-5); the FSDP+TP (``train``) and ``dp_train`` gradients of reduced
  olmo-1b on 2x4 at f32 (the loss rtol 1e-5 against the reference's
  unsharded ``loss_fn``, each gradient leaf within 1e-4 of its largest
  value against ``jax.grad``, the AdamW update against the port's
  unsharded update of the same gradients at rtol 1e-6 plus 1e-6 of the
  leaf's largest value, and a leaf whose 8 blocks lie on the 8 ranks);
  the int8 gradient sync on 8 ranks (one step's synced gradient within
  one quantisation step of the same per-shard arithmetic done with the
  reference's ``quantize_int8`` / ``dequantize_int8``; the reference
  test's quadratic below 1e-3 of its first loss); a checkpoint saved.
- 4 ranks: the sharded prefill and decode of reduced qwen2-72b on 2x2
  (``make_serve_config(cfg, 2)``, f32 compute), the cache placed by heads,
  by sequence, both with the int8 cache, and by head width (KV heads that
  do not divide the model axis), logits within 1e-3 of the reference's
  unsharded decode; the checkpoint of 8 ranks restored onto 4, exactly.
"""
import dataclasses
import os
import pathlib
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
from repro.distributed.compression import dequantize_int8, quantize_int8
from repro.distributed.ring_attention import ring_attention_ref
from repro.models import moe as jax_moe
from repro.models import zoo as jax_zoo
from repro.utils.tree import flatten_names

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
WORLD_TIMEOUT_S = 120
SEP = "|"
DECODE_CASES = ("heads", "seq", "heads_int8", "seq_int8", "hd")
DECODE_MAX_LEN = 12


def _flat(prefix: str, tree) -> dict:
    return {f"{prefix}{SEP}" + name.replace("/", SEP):
            np.asarray(leaf, np.float32)
            for name, leaf in flatten_names(tree)}


def _unstacked(grads: dict, n_layers: int) -> dict:
    out = {}
    for name, g in grads.items():
        g = np.asarray(g, np.float32)
        if name.startswith("layers/"):
            rest = name[len("layers/"):].replace("/", ".")
            for i in range(n_layers):
                out[f"layers.{i}.{rest}"] = g[i]
        else:
            out[name.replace("/", ".")] = g
    return out


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_world(d: pathlib.Path, world: int, cases: str) -> dict:
    """Start ``world`` worker ranks on ``cases``; their rank 0's results,
    or a failure with every rank's output."""
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(world), str(rank), str(d), cases],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for rank in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a {world}-rank world ({cases}) ran past "
                    f"{WORLD_TIMEOUT_S} s")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"{world}-rank world ({cases}) failed {bad}:\n" + \
        "\n".join(logs)[-6000:]
    return dict(np.load(d / f"out_{world}.npz"))


# --------------------------------------------------------------------------
# the reference's side, and the worlds
# --------------------------------------------------------------------------
def _moe_cfg(compute):
    cfg = jax_reduce_config(jax_get_config("qwen3-moe-30b-a3b"))
    return dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype=compute,
        moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


def _olmo_cfg():
    return dataclasses.replace(jax_reduce_config(jax_get_config("olmo-1b")),
                               param_dtype="float32",
                               compute_dtype="float32")


def _qk_cfg():
    return dataclasses.replace(jax_reduce_config(jax_get_config("qwen2-72b")),
                               qk_norm=True, kv_repeat=4,
                               param_dtype="float32",
                               compute_dtype="float32")


def _decode_cfg(name):
    cfg = jax_make_serve_config(jax_reduce_config(
        jax_get_config("qwen2-72b")), 2)
    kw = {"seq": dict(kv_cache_shard="seq"),
          "heads_int8": dict(kv_cache_quant=True),
          "seq_int8": dict(kv_cache_shard="seq", kv_cache_quant=True),
          "hd": dict(kv_repeat=1)}.get(name, {})
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs and the reference's results (numpy), and the directory
    the worlds share."""
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    inp, want = {}, {}
    # ring attention: the reference test's shapes
    B, S, KV, G, D = 2, 64, 2, 2, 16
    q = rng.normal(size=(B, S, KV, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    inp.update(ring_q=q, ring_k=k, ring_v=v)
    for causal in (True, False):
        want[f"ring_{causal}"] = np.asarray(ring_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    # MoE
    p = jax_moe.init_moe(jax.random.key(3), _moe_cfg("float32"))
    x = rng.normal(size=(4, 16, 64)).astype(np.float32)
    inp.update(moe_x=x, moe_router=np.asarray(p["router"]["w"]),
               **{f"moe_{n}": np.asarray(p[n])
                  for n in ("w_gate", "w_up", "w_down")})
    for compute in ("bfloat16", "float32"):
        want[f"moe_{compute}"] = np.asarray(jax_moe.moe_apply(
            p, jnp.asarray(x), _moe_cfg(compute)), np.float32)
    # training
    cfg = _olmo_cfg()
    params = jax_zoo.init_model(cfg, jax.random.key(0))
    toks = rng.integers(0, cfg.vocab, (8, 33), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    inp.update(_flat("olmo", params), train_tokens=batch["tokens"],
               train_targets=batch["targets"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda pp: jax_zoo.loss_fn(pp, cfg, jb)[0])(params)
    want["train_loss"] = float(loss)
    want["train_grads"] = dict(flatten_names(grads))
    want["olmo_layers"] = cfg.n_layers
    # tensor-parallel training: the MoE's tp_psum (no drops, as above),
    # and attention heads with biases, q/k norms and replicated KV heads
    for tag, tcfg in (("moe", _moe_cfg("float32")), ("qk", _qk_cfg())):
        tparams = jax_zoo.init_model(tcfg, jax.random.key(1))
        ttoks = rng.integers(0, tcfg.vocab, (8, 17), dtype=np.int32)
        tbatch = {"tokens": ttoks[:, :-1], "targets": ttoks[:, 1:]}
        inp.update(_flat(tag, tparams),
                   **{f"{tag}_train_{k}": v for k, v in tbatch.items()})
        jtb = {k: jnp.asarray(v) for k, v in tbatch.items()}
        loss, grads = jax.value_and_grad(
            lambda pp: jax_zoo.loss_fn(pp, tcfg, jtb)[0])(tparams)
        want[f"{tag}_train_loss"] = float(loss)
        want[f"{tag}_train_grads"] = _unstacked(dict(flatten_names(grads)),
                                                tcfg.n_layers)
    # int8 gradient sync: one step, shard by shard with the reference's
    # quantize / dequantize
    cb = rng.normal(size=(64, 32)).astype(np.float32)
    inp["cmp_batch"] = cb
    target = jnp.arange(32.0) / 32.0

    def qloss(w, b):
        return jnp.mean((b @ w - b @ target) ** 2)

    sent, scales = [], []
    for i in range(8):
        g = jax.grad(qloss)(jnp.zeros(32), jnp.asarray(cb[i * 8:(i + 1) * 8]))
        qq, sc = quantize_int8(g.astype(jnp.float32))
        sent.append(np.asarray(dequantize_int8(qq, sc)))
        scales.append(float(sc))
    want["cmp_grad"] = np.mean(sent, axis=0)
    want["cmp_step"] = max(scales)
    # decode on 2x2
    dcfg = _decode_cfg("heads")
    dparams = jax_zoo.init_model(dcfg, jax.random.key(0))
    inp.update(_flat("qwen2", dparams))
    prompt = rng.integers(0, dcfg.vocab, (4, 8), dtype=np.int32)
    feed = rng.integers(0, dcfg.vocab, (4, 3), dtype=np.int32)
    inp.update(dec_prompt=prompt, dec_feed=feed)
    for name in DECODE_CASES:
        c = _decode_cfg(name)
        caches = jax_zoo.init_cache(c, 4, DECODE_MAX_LEN)
        lg, caches = jax_zoo.decode_step(dparams, c,
                                         {"tokens": jnp.asarray(prompt)},
                                         caches, cache_index=0)
        logits = [np.asarray(lg)]
        for i in range(feed.shape[1]):
            lg, caches = jax_zoo.decode_step(
                dparams, c, {"tokens": jnp.asarray(feed[:, i:i + 1])},
                caches, cache_index=prompt.shape[1] + i)
            logits.append(np.asarray(lg))
        want[f"dec_{name}"] = np.concatenate(logits, axis=1)
    np.savez(d / "in.npz", **inp)
    return d, want


@pytest.fixture(scope="module")
def world8(reference):
    d, want = reference
    return _run_world(d, 8, "ring,moe,train,train_tp,compress,ckpt_save"), \
        want


@pytest.fixture(scope="module")
def world4(reference, world8):  # restores the checkpoint world8 saved
    d, want = reference
    return _run_world(d, 4, "decode,ckpt_restore"), want


# --------------------------------------------------------------------------
# ring attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference(world8, causal):
    got, want = world8
    err = np.abs(got[f"ring_{causal}"] - want[f"ring_{causal}"]).max()
    assert err < 3e-5, err
    # each rank held a quarter of the sequence of half the batch
    assert tuple(got[f"ring_local_{causal}"]) == (1, 16, 2, 2, 16)


def test_constrain_redistributes_a_dtensor(world8):
    got, _ = world8
    assert list(got["constrain"]) == ["(Shard(dim=0), Shard(dim=1))",
                                      "(Shard(dim=0), Shard(dim=1))",
                                      "(Shard(dim=0), Replicate())"]
    np.testing.assert_array_equal(got["constrain_full"],
                                  np.arange(64.0).reshape(8, 8))


def test_a_dtensor_never_reaches_a_kernel(world8):
    assert bool(world8[0]["kernel_refused"])


# --------------------------------------------------------------------------
# MoE tp_psum
# --------------------------------------------------------------------------
def test_moe_tp_psum_matches_reference(world8):
    got, want = world8
    np.testing.assert_allclose(got["moe_tp_bfloat16"], want["moe_bfloat16"],
                               atol=3e-2, rtol=0)
    np.testing.assert_allclose(got["moe_tp_float32"], want["moe_float32"],
                               atol=1e-5, rtol=0)


def test_moe_tp_psum_matches_local_schedule(world8):
    got, _ = world8
    np.testing.assert_allclose(got["moe_tp_float32"], got["moe_local_float32"],
                               atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "dp_train"])
def test_sharded_loss_matches_reference(world8, mode):
    got, want = world8
    np.testing.assert_allclose(got[f"{mode}_loss"], want["train_loss"],
                               rtol=1e-5)
    assert got[f"{mode}_tokens"] == 8 * 32
    np.testing.assert_allclose(got[f"{mode}_step2_loss"], want["train_loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["train", "dp_train"])
def test_sharded_gradients_match_reference(world8, mode):
    got, want = world8
    ref = _unstacked(want["train_grads"], want["olmo_layers"])
    names = sorted(k.split(SEP, 1)[1] for k in got
                   if k.startswith(f"{mode}_grad{SEP}"))
    assert names == sorted(ref)
    for name, w in ref.items():
        np.testing.assert_allclose(got[f"{mode}_grad{SEP}{name}"], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert bool(got[f"{mode}_grad_placements_match"])


@pytest.mark.parametrize("mode", ["train", "dp_train"])
def test_sharded_adamw_matches_unsharded(world8, mode):
    got, _ = world8
    gn = got[f"{mode}_gnorm"]
    np.testing.assert_allclose(gn[0], gn[1], rtol=1e-6)
    for key in got:
        for kind in ("upd", "m"):
            if not key.startswith(f"{mode}_{kind}{SEP}"):
                continue
            name = key.split(SEP, 1)[1]
            plain = got[f"{mode}_plain{kind}{SEP}{name}"]
            np.testing.assert_allclose(
                got[key], plain, rtol=1e-6,
                atol=1e-6 * np.abs(plain).max(), err_msg=key)


@pytest.mark.parametrize("tag", ["moe", "qk"])
def test_tensor_parallel_training_matches_reference(world8, tag):
    """Reduced qwen3 (the MoE's tp_psum: experts over model, the router's
    gradient summed over it) and reduced qwen2-72b with q/k norms and KV
    heads replicated 4x (each head's q/k/v columns, biases and the norms'
    gradients), FSDP + TP on 2x4, against ``jax.grad``."""
    got, want = world8
    np.testing.assert_allclose(got[f"{tag}_train_loss"],
                               want[f"{tag}_train_loss"], rtol=1e-5)
    ref = want[f"{tag}_train_grads"]
    for name, w in ref.items():
        np.testing.assert_allclose(got[f"{tag}_train_grad{SEP}{name}"], w,
                                   rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    if tag == "moe":  # 8 experts over 4 model ranks, d over 2 data ranks
        assert tuple(got["moe_train_expert_local"]) == (2, 32, 32)


def test_fsdp_tp_leaf_sharded_over_all_ranks(world8):
    got, _ = world8
    # mlp gate [64, 128]: ("data", "model") -> 8 blocks of 32 x 32
    assert list(got["train_gate_placements"]) == ["S(0)", "S(1)"]
    blocks = got["train_gate_blocks"]
    assert (blocks[:, 1] == 32 * 32).all()
    assert len(set(blocks[:, 0].tolist())) == 8
    # dp_train: FSDP over both axes, dim 0 in 8 blocks of 8 rows
    assert list(got["dp_train_gate_placements"]) == ["S(0)", "S(0)"]
    assert (got["dp_train_gate_blocks"][:, 1] == 8 * 128).all()


# --------------------------------------------------------------------------
# int8 gradient sync
# --------------------------------------------------------------------------
def test_compressed_sync_matches_reference_arithmetic(world8):
    got, want = world8
    np.testing.assert_allclose(got["cmp_grad"], want["cmp_grad"], rtol=0,
                               atol=want["cmp_step"])


def test_compressed_grad_sync_converges(world8):
    got, _ = world8
    losses = got["cmp_losses"]
    assert losses[-1] < 1e-3 * losses[0], (losses[0], losses[-1])


# --------------------------------------------------------------------------
# serving on 2x2
# --------------------------------------------------------------------------
PLACEMENTS = {"heads": "S(3)", "seq": "S(2)", "heads_int8": "S(3)",
              "seq_int8": "S(2)", "hd": "S(4)"}


@pytest.mark.parametrize("case", DECODE_CASES)
def test_sharded_decode_matches_reference(world4, case):
    got, want = world4
    assert got[f"dec_{case}"].shape == want[f"dec_{case}"].shape == (
        4, 4, 256)
    np.testing.assert_allclose(got[f"dec_{case}"], want[f"dec_{case}"],
                               rtol=0, atol=1e-3)
    # batch over data, the cache's own axis over model
    assert list(got[f"dec_{case}_kplace"]) == ["S(1)", PLACEMENTS[case]]


# --------------------------------------------------------------------------
# checkpoint: elastic reshard 8 -> 4
# --------------------------------------------------------------------------
def test_checkpoint_elastic_reshard(world4):
    got, _ = world4
    want = np.arange(64.0).reshape(8, 8)
    np.testing.assert_array_equal(got["ck_full"], want)
    np.testing.assert_array_equal(got["ck_blocks"].reshape(8, 8), want)
    assert list(got["ck_placements"]) == ["S(0)"]
