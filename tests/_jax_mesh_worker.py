"""The reference's own bf16 schedules on a mesh, for the port's bf16 gloo
worlds to be held against (``tests/_torch_bf16.py``).

    XLA_FLAGS="--xla_force_host_platform_device_count=8 \\
        --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1" \\
        python tests/_jax_mesh_worker.py <dir> <world> [families]

(``_torch_bf16.XLA_FLAGS``: one thread per device, so that the sums do
not change with the host's core count.)

Runs in a process of its own, since XLA's host device count is fixed when
JAX starts (the test process sees one device).  Reads ``<dir>/in.npz``
(the weights and inputs the test wrote), runs every case of
``_torch_bf16.cases(world, families)``, on a
``("data", "model")`` mesh of the case's shape over the first host
devices, as the reference places and runs it: the parameters by
``param_shardings``, the batch by ``batch_shardings``, the caches by
``cache_shardings``, the step jitted under the case's rules, GSPMD
partitioning it; and each case again on one device, unsharded.  The
meshes are built with ``jax.sharding.Mesh``, whose axes are ``Auto``
(``jax.make_mesh`` makes ``Explicit`` ones on this JAX, which the
reference's ``with_sharding_constraint`` refuses).  Writes
``<dir>/ref_<world>.npz``: per training case the loss and each gradient
leaf by the port's names, per serving case the greedy tokens and the
teacher-forced logits, and, for the 8-rank world of the cases that are
not the families', the MoE's ``tp_psum`` in bf16 on 2x4.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import base
from repro.distributed import sharding as shd
from repro.distributed.ctx import (SERVE_RULES_1POD, TRAIN_RULES_1POD,
                                   ShardingRules, dp_rules, use_sharding)
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.models import zoo
from repro.utils.tree import flatten_names, tree_map_with_name

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16 as bf16  # noqa: E402
from _torch_ssd import segsum_decay_masked_first  # noqa: E402

SEP = bf16.SEP
STACKS = ("layers", "dense_layers")
#: each arch's one-device loss and gradients, computed once
ONE_DEVICE: dict = {}


def mesh_of(dims) -> Mesh:
    n = bf16.world_of(dims)
    return Mesh(np.array(jax.devices()[:n]).reshape(dims), ("data", "model"))


def params_for(inp, cfg, arch: str) -> dict:
    """``arch``'s weights from ``in.npz``, in the tree and the dtypes
    ``init_model`` gives ``cfg`` (bf16 under a serving config)."""
    prefix = bf16.weights_key(arch)
    shapes = jax.eval_shape(lambda k: zoo.init_model(cfg, k),
                            jax.random.key(0))
    return tree_map_with_name(lambda name, leaf: jnp.asarray(
        inp[prefix + SEP + name.replace("/", SEP)]).astype(leaf.dtype),
        shapes)


def port_names(grads) -> dict:
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


def run_train(inp, out, tag, arch, dims, mode):
    """The loss and each gradient leaf of one training case, on its mesh
    (``<tag>|...``) and on one device (``one|<tag>|...``)."""
    cfg = bf16.train_config(base, arch)
    params = params_for(inp, cfg, arch)
    batch = {k: jnp.asarray(inp[f"bf16_{arch}_{k}"])
             for k in ("tokens", "targets")}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: zoo.loss_fn(p, cfg, b)[0]))
    mesh = mesh_of(dims)
    rules = TRAIN_RULES_1POD if mode == "train" else dp_rules(mesh.axis_names)
    placed = jax.device_put(params, shd.param_shardings(params, cfg, mesh,
                                                        mode=mode))
    with use_sharding(rules, mesh):
        loss, grads = grad_fn(placed, jax.device_put(
            batch, shd.batch_shardings(batch, mesh, rules)))
    if arch not in ONE_DEVICE:  # the same on every mesh and mode
        ONE_DEVICE[arch] = grad_fn(params, batch)
    runs = {tag: (loss, grads), f"one{SEP}{tag}": ONE_DEVICE[arch]}
    for key, (loss, grads) in runs.items():
        out[f"{key}{SEP}loss"] = np.float64(loss)
        for name, g in port_names(grads).items():
            out[f"{key}{SEP}grad{SEP}{name}"] = g


def _serve_steps(step, params, cfg, prompt, feed, put, cache_put):
    """greedy_generate's loop (a prefill, then NEW - 1 decode steps): the
    free-running tokens [B, NEW], and the logits [B, NEW, V] of the same
    steps fed ``feed`` (teacher-forced)."""
    B, S0 = prompt.shape
    got = {}
    for forced in (False, True):
        cache = cache_put(zoo.init_cache(cfg, B, S0 + bf16.NEW))
        logits, cache = step(params, {"tokens": put(prompt)}, cache,
                             jnp.int32(0))
        seen = [logits[:, -1]]
        for i in range(bf16.NEW - 1):
            toks = feed[:, i] if forced else jnp.argmax(seen[-1], axis=-1)
            logits, cache = step(params, {"tokens": put(toks[:, None])},
                                 cache, jnp.int32(S0 + i))
            seen.append(logits[:, -1])
        seen = np.asarray(jnp.stack(seen, axis=1), np.float32)
        got["forced" if forced else "tokens"] = seen if forced else \
            seen.argmax(-1)
    return got


def run_serve(inp, out, tag, arch, dims):
    """One serving case's tokens and teacher-forced logits
    (``_serve_steps``), on its mesh (the parameters, caches and prompts
    placed by the reference's specs, under ``SERVE_RULES_1POD``;
    ``<tag>|...``) and on one device (``one|<tag>|...``)."""
    cfg = bf16.serve_config(base, shd, arch, dims)
    params = params_for(inp, cfg, arch)
    prompt = jnp.asarray(inp[f"bf16_{arch}_prompt"])
    feed = jnp.asarray(inp[f"bf16_{arch}_feed"])
    step = jax.jit(lambda p, b, c, i: zoo.decode_step(
        p, cfg, b, c, cache_index=i))
    runs = {f"one{SEP}{tag}": _serve_steps(step, params, cfg, prompt, feed,
                                          lambda t: t, lambda c: c)}
    mesh = mesh_of(dims)
    placed = jax.device_put(params, shd.param_shardings(params, cfg, mesh,
                                                        mode="serve"))
    with use_sharding(SERVE_RULES_1POD, mesh):
        runs[tag] = _serve_steps(
            step, placed, cfg, prompt, feed,
            lambda t: jax.device_put(t, shd.batch_shardings(
                t, mesh, SERVE_RULES_1POD)),
            lambda c: jax.device_put(c, shd.cache_shardings(c, cfg, mesh)))
    for key, got in runs.items():
        for name, value in got.items():
            out[f"{key}{SEP}{name}"] = value


def run_moe(inp, out):
    """``moe_apply`` under ``_moe_tp_psum`` on 2x4 in bf16 (the reference
    test's rules: batch over data, experts over model), and the same
    routed layer whole (``local``), on ``tests/test_torch_distributed.py``'s
    MoE input."""
    cfg = bf16.train_config(base, "qwen3-moe-30b-a3b")
    p = {"router": {"w": jnp.asarray(inp["moe_router"])},
         **{n: jnp.asarray(inp[f"moe_{n}"])
            for n in ("w_gate", "w_up", "w_down")}}
    x = jnp.asarray(inp["moe_x"])
    mesh = mesh_of((2, 4))
    rules = ShardingRules(rules={"batch": "data", "experts": "model"})
    with use_sharding(rules, mesh):
        xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
        ps = jax.device_put(p, NamedSharding(mesh, P()))
        y = jax.jit(lambda pp, xx: jax_moe.moe_apply(pp, xx, cfg))(ps, xs)
    out["moe_tp_bfloat16"] = np.asarray(y, np.float32)
    out["moe_local_bfloat16"] = np.asarray(jax_moe.moe_apply(p, x, cfg),
                                           np.float32)


def main() -> int:
    d, world = sys.argv[1], int(sys.argv[2])
    families = len(sys.argv) > 3 and sys.argv[3] == "families"
    # the hybrid's Mamba-2 gradient is NaN under the reference's own decay
    # (tests/_torch_ssd.py); the same values, masked before the exp
    jax_ssm._segsum_decay = segsum_decay_masked_first
    inp = np.load(os.path.join(d, "in.npz"))
    out: dict = {}
    train, serve = bf16.cases(world, families)
    for case in train:
        run_train(inp, out, *case)
    for case in serve:
        run_serve(inp, out, *case)
    if world == 8 and not families:
        run_moe(inp, out)
    np.savez(os.path.join(d, f"ref_{world}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
