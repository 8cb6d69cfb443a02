"""One rank of the multi-rank CPU tests (``tests/test_torch_distributed.py``,
``tests/test_torch_distributed_families.py``).

    python tests/_torch_dist_worker.py <world> <rank> <dir> <case,case,...>
    python tests/_torch_dist_worker.py fake <world> <dir> <case,case,...>

Each rank joins a gloo world through a ``FileStore`` under ``<dir>``, reads
the inputs the test wrote (``<dir>/in.npz``: numpy arrays made from a seed,
and the reference's weights and results), runs the cases in order on the
port (``repro_torch``; this process imports neither JAX nor ``repro``),
and rank 0 writes what the test compares to ``<dir>/out_<world>.npz``.
A case that raises ends the rank with exit code 1, after printing its
traceback.  ``fake`` runs one process as rank 0 of a ``fake`` world of
``<world>`` ranks (``launch/mesh.py::fake_world``), on ``meta`` tensors,
and writes ``<dir>/out_fake<world>.npz``.
"""
import contextlib
import dataclasses
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import (get_config, make_serve_config,
                                      reduce_config)
from repro_torch.distributed import parallel
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import make_dp_compressed_grad_fn
from repro_torch.distributed.ctx import (P, SERVE_RULES_1POD,
                                         TRAIN_RULES_1POD, ShardingRules,
                                         constrain, dp_rules, use_sharding)
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.launch.analytic_cost import StepCount
from repro_torch.launch.mesh import Mesh, fake_world, init_mesh
from repro_torch.models import params_from_numpy, zoo
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_train_step

import _torch_bf16 as bf16

SEP = "|"  # stands for "/" in the names of the npz archives
#: the mesh of a ``fake`` world (``main``), None in a gloo world
FAKE_MESH = None


def world_mesh(dims):
    """The ``dims`` mesh over this world: gloo's, or the fake world's."""
    if FAKE_MESH is not None:
        assert FAKE_MESH.sizes == tuple(dims), (FAKE_MESH.sizes, dims)
        return FAKE_MESH
    return init_mesh(dims, "cpu")


def tree(inp, prefix: str) -> dict:
    """The nested reference tree stored flat under ``prefix``."""
    out: dict = {}
    for key in inp.files:
        if not key.startswith(prefix + SEP):
            continue
        node = out
        parts = key[len(prefix) + 1:].split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inp[key]
    return out


def full(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().numpy()


# ------------------------------------------------------------------ cases
def case_ring(inp, out, d):
    mesh = init_mesh((2, 4), "cpu")
    q, k, v = (torch.from_numpy(inp[f"ring_{n}"]) for n in "qkv")
    for causal in (True, False):
        got = ring_attention(q, k, v, mesh=mesh, causal=causal)
        out[f"ring_{causal}"] = full(got)
        out[f"ring_local_{causal}"] = np.array(got.to_local().shape)
    # constrain: a DTensor redistributed to the rules' placements
    x = shd.NamedSharding(mesh, P()).distribute(torch.arange(64.0).reshape(8, 8))
    with use_sharding(TRAIN_RULES_1POD, mesh):
        y = constrain(x, "batch", "heads")
        z = constrain(x, "batch", "vocab")  # 8 % 4: kept; odd dims dropped
        w = constrain(x[:, :3], "batch", "heads")
    out["constrain"] = np.array([str(t.placements) for t in (y, z, w)])
    out["constrain_full"] = full(y)
    # a DTensor never reaches a kernel, not even its plain version
    try:
        flash_attention_op(y[None, None], y[None, None], y[None, None])
        out["kernel_refused"] = np.array(False)
    except TypeError:
        out["kernel_refused"] = np.array(True)


def moe_config(compute: str):
    cfg = reduce_config(get_config("qwen3-moe-30b-a3b"))
    return dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype=compute,
        moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


def case_moe(inp, out, d):
    mesh = init_mesh((2, 4), "cpu")
    x = torch.from_numpy(inp["moe_x"])
    rules = ShardingRules(rules={"batch": "data", "experts": "model"})
    for compute in ("bfloat16", "float32"):
        cfg = moe_config(compute)
        moe = MoE(cfg, device="cpu")
        with torch.no_grad():
            moe.router.w.copy_(torch.from_numpy(inp["moe_router"]))
            for n in ("w_gate", "w_up", "w_down"):
                getattr(moe, n).copy_(torch.from_numpy(inp[f"moe_{n}"]))
            out[f"moe_local_{compute}"] = moe_apply(moe, x, cfg).float().numpy()
            with use_sharding(rules, mesh):
                y = moe_apply(moe, parallel.batch_rows(x), cfg)
                out[f"moe_tp_{compute}"] = parallel.gather_rows(
                    y).float().numpy()


def olmo_config():
    return dataclasses.replace(reduce_config(get_config("olmo-1b")),
                               param_dtype="float32",
                               compute_dtype="float32")


def case_train(inp, out, d):
    mesh = init_mesh((2, 4), "cpu")
    cfg = olmo_config()
    ref = tree(inp, "olmo")
    batch = {k: torch.from_numpy(inp[f"train_{k}"])
             for k in ("tokens", "targets")}
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    for mode in ("train", "dp_train"):
        rules = TRAIN_RULES_1POD if mode == "train" else dp_rules(
            mesh.axis_names)
        model = shd.shard_model(params_from_numpy(cfg, ref, device="cpu"),
                                cfg, mesh, mode=mode)
        params = dict(model.named_parameters())
        with use_sharding(rules, mesh):
            local = {k: parallel.batch_rows(v) for k, v in batch.items()}
            model.requires_grad_(True)
            loss, metrics = zoo.loss_fn(model, cfg, local)
            grads = torch.autograd.grad(loss, list(params.values()))
            model.requires_grad_(False)
        grads = dict(zip(params, grads))
        out[f"{mode}_loss"] = np.float64(loss.item())
        out[f"{mode}_tokens"] = np.float64(metrics["tokens"].item())
        for name, g in grads.items():
            out[f"{mode}_grad{SEP}{name}"] = full(g)
        gate = model.layers[0].mlp.gate.w
        blocks = [torch.empty(2) for _ in range(dist.get_world_size())]
        mine = gate.to_local()
        dist.all_gather(blocks, torch.tensor([mine[0, 0].item(),
                                              float(mine.numel())]))
        out[f"{mode}_gate_blocks"] = torch.stack(blocks).numpy()
        out[f"{mode}_gate_placements"] = np.array(
            [str(p) for p in gate.placements])
        out[f"{mode}_grad_placements_match"] = np.array(all(
            g.placements == params[n].placements for n, g in grads.items()))
        # AdamW on these gradients, sharded, against the unsharded update
        # of the same gradients
        opt = init_opt_state(params)
        with use_sharding(rules, mesh):
            _, opt, met = adamw_update(grads, opt, params, opt_cfg)
        plain = params_from_numpy(cfg, ref, device="cpu")
        pp = dict(plain.named_parameters())
        popt = init_opt_state(pp)
        _, popt, pmet = adamw_update({n: torch.from_numpy(full(g))
                                      for n, g in grads.items()}, popt, pp,
                                     opt_cfg)
        out[f"{mode}_gnorm"] = np.array([met["grad_norm"].item(),
                                         pmet["grad_norm"].item()])
        for name, p in params.items():
            out[f"{mode}_upd{SEP}{name}"] = full(p)
            out[f"{mode}_plainupd{SEP}{name}"] = full(pp[name])
            out[f"{mode}_m{SEP}{name}"] = full(opt["m"][name])
            out[f"{mode}_plainm{SEP}{name}"] = full(popt["m"][name])
        # the whole step, sharded, from the same weights
        model = shd.shard_model(params_from_numpy(cfg, ref, device="cpu"),
                                cfg, mesh, mode=mode)
        opt = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, opt_cfg)
        with use_sharding(rules, mesh):
            model, opt, met = step(model, opt, batch)
        out[f"{mode}_step2_loss"] = np.float64(met["loss"].item())


def qk_config():
    """Reduced qwen2-72b (q/k/v biases) with q/k norms and KV heads
    replicated 4x: on 2x4 every head's parameters are split or summed
    over model."""
    return dataclasses.replace(reduce_config(get_config("qwen2-72b")),
                               qk_norm=True, kv_repeat=4,
                               param_dtype="float32", compute_dtype="float32")


def case_train_tp(inp, out, d):
    """FSDP + TP gradients on 2x4 of reduced qwen3 (the experts split over
    model, their router's gradient summed over it) and of ``qk_config``."""
    mesh = init_mesh((2, 4), "cpu")
    for tag, cfg in (("moe", moe_config("float32")), ("qk", qk_config())):
        model = shd.shard_model(params_from_numpy(cfg, tree(inp, tag),
                                                  device="cpu"),
                                cfg, mesh, mode="train")
        params = dict(model.named_parameters())
        batch = {k: torch.from_numpy(inp[f"{tag}_train_{k}"])
                 for k in ("tokens", "targets")}
        with use_sharding(TRAIN_RULES_1POD, mesh):
            local = {k: parallel.batch_rows(v) for k, v in batch.items()}
            model.requires_grad_(True)
            loss, _ = zoo.loss_fn(model, cfg, local)
            grads = torch.autograd.grad(loss, list(params.values()))
            model.requires_grad_(False)
        out[f"{tag}_train_loss"] = np.float64(loss.item())
        for name, g in zip(params, grads):
            out[f"{tag}_train_grad{SEP}{name}"] = full(g)
        if tag == "moe":
            out["moe_train_expert_local"] = np.array(
                model.layers[0].moe.w_gate.to_local().shape)


def case_compress(inp, out, d):
    mesh = init_mesh((8,), "cpu", ("data",))
    target = torch.arange(32.0) / 32.0

    def loss_fn(params, batch):
        pred = batch @ params["w"]
        return torch.mean((pred - batch @ target) ** 2)

    grad_fn = make_dp_compressed_grad_fn(loss_fn, mesh)
    params = {"w": torch.zeros(32)}
    residuals = {"w": torch.zeros(32)}
    loss, grads, _ = grad_fn(params, torch.from_numpy(inp["cmp_batch"]),
                             residuals)
    out["cmp_grad"] = grads["w"].numpy()
    out["cmp_loss"] = np.float64(loss.item())
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(60):
        batch = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
        loss, grads, residuals = grad_fn(params, batch, residuals)
        params = {k: p - 0.3 * grads[k] for k, p in params.items()}
        losses.append(loss.item())
    out["cmp_losses"] = np.array(losses)


def case_ckpt_save(inp, out, d):
    mesh = init_mesh((8,), "cpu", ("data",))
    w = shd.NamedSharding(mesh, P("data", None)).distribute(
        torch.arange(64.0).reshape(8, 8))
    CheckpointManager(os.path.join(d, "ckpt")).save(1, {"w": w})


def case_ckpt_restore(inp, out, d):
    mesh = init_mesh((4,), "cpu", ("data",))
    target = {"w": torch.zeros(8, 8)}
    shardings = {"w": shd.NamedSharding(mesh, P("data", None))}
    got, _ = CheckpointManager(os.path.join(d, "ckpt")).restore(
        target, shardings=shardings)
    w = got["w"]
    blocks = [torch.empty(2, 8) for _ in range(dist.get_world_size())]
    dist.all_gather(blocks, w.to_local().contiguous())
    out["ck_blocks"] = torch.stack(blocks).numpy()
    out["ck_full"] = full(w)
    out["ck_placements"] = np.array([str(p) for p in w.placements])


DECODE_CASES = {"heads": {}, "seq": dict(kv_cache_shard="seq"),
                "heads_int8": dict(kv_cache_quant=True),
                "seq_int8": dict(kv_cache_shard="seq", kv_cache_quant=True),
                "hd": dict(kv_repeat=1)}
DECODE_MAX_LEN = 12


def decode_config(kw):
    cfg = make_serve_config(reduce_config(get_config("qwen2-72b")), 2)
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def case_decode(inp, out, d):
    mesh = init_mesh((2, 2), "cpu")
    ref = tree(inp, "qwen2")
    prompt = inp["dec_prompt"]
    feed = inp["dec_feed"]
    for name, kw in DECODE_CASES.items():
        cfg = decode_config(kw)
        model = shd.shard_model(params_from_numpy(cfg, ref, device="cpu"),
                                cfg, mesh, mode="serve")
        prefill = make_prefill_step(cfg, DECODE_MAX_LEN, device="cpu")
        decode = make_decode_step(cfg, device="cpu")
        logits = []
        with torch.no_grad(), use_sharding(SERVE_RULES_1POD, mesh):
            lg, caches = prefill(model, {"tokens": prompt})
            logits.append(lg)
            for i in range(feed.shape[1]):
                lg, caches = decode(model, caches, {"tokens": feed[:, i:i + 1]},
                                    prompt.shape[1] + i)
                logits.append(lg)
        out[f"dec_{name}"] = torch.cat(logits, dim=1).numpy()
        k = caches["layers"]["k"]
        out[f"dec_{name}_kplace"] = np.array([str(p) for p in k.placements])


# --------------------------------------------- the SSM, hybrid, enc-dec, VLM
FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b", "seamless-m4t-medium",
                "internvl2-26b")
#: the leaves whose compute tensors a rank records: one per new schedule
FAMILY_PROBES = ("layers.0.mamba.in_proj", "layers.0.mamba.in_x",
                 "shared_attn.attn.wq", "dec_layers.0.cross.wq",
                 "projector.fc1", "layers.0.attn.wq", "layers.0.mlp.gate")
FAMILY_NEW = 4


def family_config(arch: str):
    return dataclasses.replace(reduce_config(get_config(arch)),
                               param_dtype="float32", compute_dtype="float32")


def family_serve_config(arch: str, mesh):
    """``make_serve_config`` for the model axis, then the cache policy
    ``choose_serve_cache_policy`` picks, in f32."""
    cfg = make_serve_config(family_config(arch), mesh.shape["model"])
    return dataclasses.replace(cfg, param_dtype="float32",
                               **shd.choose_serve_cache_policy(cfg, mesh))


class LocalLeaves:
    """Records, for the length of the block, the compute tensor of each
    ``Dense`` of ``model`` named in :data:`FAMILY_PROBES` at its first
    call (``dense_apply``, or ``dense_cols`` of several): the local
    tensor a rank multiplies by."""

    MODULES = ("ssm", "blocks", "attention", "zoo", "layers")
    FUNCTIONS = ("dense_apply", "dense_cols")

    def __init__(self, model):
        self.names = {id(m): n for n, m in model.named_modules()
                      if n in FAMILY_PROBES}
        self.seen: dict = {}

    def __enter__(self):
        import importlib

        self.saved = []
        for name in self.MODULES:
            mod = importlib.import_module(f"repro_torch.models.{name}")
            for fn in self.FUNCTIONS:
                orig = getattr(mod, fn, None)
                if orig is None:
                    continue

                def wrapped(p, x, *a, _orig=orig, **k):
                    for q in (p if isinstance(p, (list, tuple)) else [p]):
                        n = self.names.get(id(q))
                        if n is not None and n not in self.seen:
                            self.seen[n] = q.w.detach().clone()
                    return _orig(p, x, *a, **k)

                setattr(mod, fn, wrapped)
                self.saved.append((mod, fn, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self.saved:
            setattr(mod, fn, orig)


def placements(model) -> dict:
    return {name: np.array([str(pl) for pl in p.placements])
            for name, p in model.named_parameters()}


def family_batch(inp, tag: str) -> dict:
    return {k: torch.from_numpy(inp[f"{tag}_train_{k}"])
            for k in ("tokens", "targets", "frames", "patch_embeds")
            if f"{tag}_train_{k}" in inp.files}


def case_families_train(inp, out, d):
    """Each family on 2x2: FSDP + TP (``train``) and ``dp_train``: the
    loss and every gradient leaf, the placements, the local compute
    tensors of the probes, and one whole train step's loss."""
    mesh = init_mesh((2, 2), "cpu")
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    for arch in FAMILY_ARCHS:
        cfg = family_config(arch)
        ref = tree(inp, arch)
        batch = family_batch(inp, arch)
        for mode in ("train", "dp_train"):
            rules = TRAIN_RULES_1POD if mode == "train" else dp_rules(
                mesh.axis_names)
            model = shd.shard_model(params_from_numpy(cfg, ref, device="cpu"),
                                    cfg, mesh, mode=mode)
            params = dict(model.named_parameters())
            tag = f"{arch}_{mode}"
            with use_sharding(rules, mesh), LocalLeaves(model) as probe:
                local = {k: parallel.batch_rows(v) for k, v in batch.items()}
                model.requires_grad_(True)
                loss, _ = zoo.loss_fn(model, cfg, local)
                grads = torch.autograd.grad(loss, list(params.values()))
                model.requires_grad_(False)
            out[f"{tag}_loss"] = np.float64(loss.item())
            for name, g in zip(params, grads):
                out[f"{tag}_grad{SEP}{name}"] = full(g)
            for name, pl in placements(model).items():
                out[f"{tag}_place{SEP}{name}"] = pl
            for name, t in probe.seen.items():
                out[f"{tag}_local{SEP}{name}"] = t.float().numpy()
            if mode == "train":  # the whole step, frames or patches split
                step = make_train_step(cfg, opt_cfg)
                opt = init_opt_state(params)
                with use_sharding(rules, mesh):
                    model, opt, met = step(model, opt, batch)
                out[f"{tag}_step_loss"] = np.float64(met["loss"].item())


def case_families_serve(inp, out, d):
    """Each family on 1x4 in ``serve`` mode under its serve cache policy:
    a prefill and teacher-forced decode steps (logits), greedy tokens
    (``greedy_generate``), placements of the parameters and caches; the
    SSM and hybrid batchers sharded against unsharded."""
    from repro_torch.serve import ContinuousBatcher, greedy_generate

    mesh = init_mesh((1, 4), "cpu")
    for arch in FAMILY_ARCHS:
        cfg = family_serve_config(arch, mesh)
        ref = tree(inp, arch)
        model = shd.shard_model(params_from_numpy(cfg, ref, device="cpu"),
                                cfg, mesh, mode="serve")
        prompt = inp[f"{arch}_serve_prompt"]
        feed = inp[f"{arch}_serve_feed"]
        first = {"tokens": prompt}
        for k in ("frames", "patch_embeds"):
            if f"{arch}_serve_{k}" in inp.files:
                first[k] = inp[f"{arch}_serve_{k}"]
        start = prompt.shape[1] + (first["patch_embeds"].shape[1]
                                   if "patch_embeds" in first else 0)
        max_len = start + feed.shape[1] + 1
        prefill = make_prefill_step(cfg, max_len, device="cpu")
        decode = make_decode_step(cfg, device="cpu")
        rules = SERVE_RULES_1POD
        with torch.no_grad(), use_sharding(rules, mesh), \
                LocalLeaves(model) as probe:
            enc = (zoo.encode_frames(model, cfg, torch.from_numpy(
                first["frames"])) if cfg.is_encdec else None)
            extra = {} if enc is None else {"enc_out": enc}
            lg, caches = prefill(model, first)
            logits = [lg]
            for i in range(feed.shape[1]):
                lg, caches = decode(model, caches, {
                    "tokens": feed[:, i:i + 1], **extra}, start + i)
                logits.append(lg)
            out[f"{arch}_serve_logits"] = torch.cat(logits, 1).numpy()
            out[f"{arch}_serve_greedy"] = greedy_generate(
                model, cfg, prompt, max_new=FAMILY_NEW, enc_out=enc,
                device="cpu").numpy()
        for key, stack in caches.items():
            for n, t in stack.items():
                out[f"{arch}_serve_cache{SEP}{key}{SEP}{n}"] = np.array(
                    [str(pl) for pl in t.placements])
        for name, pl in placements(model).items():
            out[f"{arch}_serve_place{SEP}{name}"] = pl
        for name, t in probe.seen.items():
            out[f"{arch}_serve_local{SEP}{name}"] = t.float().numpy()
        if cfg.family not in ("ssm", "hybrid"):
            continue
        # two waves of the batcher: its SSM state zeroed on the blocks
        waves = inp[f"{arch}_serve_waves"]
        runs = []
        for sharded in (True, False):
            m = (model if sharded else
                 params_from_numpy(cfg, ref, device="cpu"))
            scope = (use_sharding(rules, mesh) if sharded
                     else contextlib.nullcontext())
            with scope:
                b = ContinuousBatcher(cfg, m, slots=2, max_len=32,
                                      device="cpu")
                for row in waves:
                    b.submit(row, FAMILY_NEW)
                b.run_until_drained()
            runs.append(np.array([r.out_tokens for r in sorted(
                b.finished, key=lambda r: r.rid)]))
        out[f"{arch}_batcher"] = np.stack(runs)


# ------------------------------ the vocabulary and MLA's heads over model
VOCAB_ARCHS = ("smollm-135m", "qwen2-72b", "deepseek-v2-lite-16b")
VOCAB_SERVE_ARCHS = ("smollm-135m", "deepseek-v2-lite-16b")
VOCAB_NEW = 4


def vocab_config(arch: str):
    """Reduced ``arch`` in f32 (the MoE without drops, as ``moe_config``)."""
    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              param_dtype="float32", compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=100.0))
    return cfg


def vocab_serve_config(arch: str, model_axis: int):
    cfg = make_serve_config(vocab_config(arch), model_axis)
    return dataclasses.replace(cfg, param_dtype="float32")


def _local_widths(model, cfg) -> np.ndarray:
    """The compute tensors' shapes of the embedding table, the output
    projection (or the tied table) and, for MLA, the first layer's
    ``wkv_b`` and ``wo``: this rank's rows, columns and heads."""
    with zoo._top_params(model, cfg):
        head = model.embed.table if cfg.tie_embeddings else model.lm_head.w
        shapes = [tuple(model.embed.table.shape), tuple(head.shape)]
    if cfg.mla is not None:
        layer = model.layers[0]
        with parallel.local_params(layer, cfg):
            shapes += [tuple(layer.attn.wkv_b.w.shape),
                       tuple(layer.attn.wo.w.shape)]
    return np.array(shapes)


def case_vocab_train(inp, out, d):
    """FSDP + TP of each of ``VOCAB_ARCHS`` on 2x4 (8 ranks) or 2x2 (4):
    the loss and every gradient leaf, and the local widths."""
    dims = (2, 4) if dist.get_world_size() == 8 else (2, 2)
    mesh = init_mesh(dims, "cpu")
    for arch in VOCAB_ARCHS:
        cfg = vocab_config(arch)
        model = shd.shard_model(params_from_numpy(cfg, tree(inp, arch),
                                                  device="cpu"),
                                cfg, mesh, mode="train")
        params = dict(model.named_parameters())
        batch = {k: torch.from_numpy(inp[f"{arch}_train_{k}"])
                 for k in ("tokens", "targets")}
        tag = f"{arch}_{dims[0]}x{dims[1]}"
        with use_sharding(TRAIN_RULES_1POD, mesh):
            local = {k: parallel.batch_rows(v) for k, v in batch.items()}
            model.requires_grad_(True)
            loss, _ = zoo.loss_fn(model, cfg, local)
            grads = torch.autograd.grad(loss, list(params.values()))
            model.requires_grad_(False)
            out[f"{tag}_widths"] = _local_widths(model, cfg)
        out[f"{tag}_loss"] = np.float64(loss.item())
        for name, g in zip(params, grads):
            out[f"{tag}_grad{SEP}{name}"] = full(g)


def case_vocab_serve(inp, out, d):
    """Each of ``VOCAB_SERVE_ARCHS`` on 1x4 in ``serve`` mode: greedy
    tokens (``greedy_generate``), the batcher's tokens of two waves, and
    the local widths."""
    from repro_torch.serve import ContinuousBatcher, greedy_generate

    mesh = init_mesh((1, 4), "cpu")
    for arch in VOCAB_SERVE_ARCHS:
        cfg = vocab_serve_config(arch, 4)
        model = shd.shard_model(params_from_numpy(cfg, tree(inp, arch),
                                                  device="cpu"),
                                cfg, mesh, mode="serve")
        with torch.no_grad(), use_sharding(SERVE_RULES_1POD, mesh):
            out[f"{arch}_greedy"] = greedy_generate(
                model, cfg, inp[f"{arch}_prompt"], max_new=VOCAB_NEW,
                device="cpu").numpy()
            b = ContinuousBatcher(cfg, model, slots=2, max_len=32,
                                  device="cpu")
            for row in inp[f"{arch}_waves"]:
                b.submit(row, VOCAB_NEW)
            b.run_until_drained()
            out[f"{arch}_batcher"] = np.array([r.out_tokens for r in sorted(
                b.finished, key=lambda r: r.rid)])
            out[f"{arch}_serve_widths"] = _local_widths(model, cfg)


# ------------------------------------------------------------ bf16 past 1x1
def bf16_train(inp, out, tag, arch, dims, mode):
    """One training case of ``_torch_bf16.TRAIN``: the loss, every gradient
    leaf and the local widths of the vocabulary (and MLA's heads)."""
    from repro_torch.configs import base

    mesh = init_mesh(dims, "cpu")
    cfg = bf16.train_config(base, arch)
    model = shd.shard_model(params_from_numpy(
        cfg, tree(inp, bf16.weights_key(arch)), device="cpu"), cfg, mesh,
        mode=mode)
    params = dict(model.named_parameters())
    rules = TRAIN_RULES_1POD if mode == "train" else dp_rules(mesh.axis_names)
    batch = {k: torch.from_numpy(inp[f"bf16_{arch}_{k}"])
             for k in ("tokens", "targets")}
    with use_sharding(rules, mesh):
        local = {k: parallel.batch_rows(v) for k, v in batch.items()}
        model.requires_grad_(True)
        loss, _ = zoo.loss_fn(model, cfg, local)
        grads = torch.autograd.grad(loss, list(params.values()))
        model.requires_grad_(False)
        out[f"{tag}{SEP}widths"] = _local_widths(model, cfg)
    out[f"{tag}{SEP}loss"] = np.float64(loss.item())
    for name, g in zip(params, grads):
        out[f"{tag}{SEP}grad{SEP}{name}"] = full(g)


def bf16_serve(inp, out, tag, arch, dims):
    """One serving case of ``_torch_bf16.SERVE``: ``greedy_generate``'s
    tokens, and the teacher-forced logits of the same steps."""
    from repro_torch.configs import base
    from repro_torch.serve import greedy_generate

    mesh = init_mesh(dims, "cpu")
    cfg = bf16.serve_config(base, shd, arch, dims)
    model = shd.shard_model(params_from_numpy(
        cfg, tree(inp, bf16.weights_key(arch)), device="cpu"), cfg, mesh,
        mode="serve")
    with torch.no_grad(), use_sharding(SERVE_RULES_1POD, mesh):
        out[f"{tag}{SEP}tokens"] = greedy_generate(
            model, cfg, inp[f"bf16_{arch}_prompt"], max_new=bf16.NEW,
            device="cpu").numpy()
        out[f"{tag}{SEP}forced"] = forced_logits(model, cfg, inp, arch)


def forced_logits(model, cfg, inp, arch) -> np.ndarray:
    """The last position's logits [B, NEW, V] of a prefill of ``arch``'s
    prompt and NEW - 1 decode steps fed its ``feed`` tokens."""
    prompt, feed = inp[f"bf16_{arch}_prompt"], inp[f"bf16_{arch}_feed"]
    S0 = prompt.shape[1]
    prefill = make_prefill_step(cfg, S0 + bf16.NEW, device="cpu")
    decode = make_decode_step(cfg, device="cpu")
    logits, caches = prefill(model, {"tokens": prompt})
    seen = [logits[:, -1]]
    for i in range(bf16.NEW - 1):
        logits, caches = decode(model, caches, {"tokens": feed[:, i:i + 1]},
                                S0 + i)
        seen.append(logits[:, -1])
    return torch.stack(seen, dim=1).float().numpy()


def bf16_unsharded(inp, families: bool) -> dict:
    """Every bf16 case of ``_torch_bf16`` on one device, unsharded (no
    process group; the test process runs it): ``one|<tag>|loss``, its
    gradient leaves, ``one|<tag>|tokens`` and ``one|<tag>|forced``."""
    from repro_torch.configs import base
    from repro_torch.serve import greedy_generate

    out, grads = {}, {}
    train = [c for c in bf16.TRAIN if (c[1] in bf16.FAMILY_ARCHS) == families]
    serve = [c for c in bf16.SERVE if (c[1] in bf16.FAMILY_ARCHS) == families]
    for tag, arch, _, _ in train:
        if arch not in grads:  # the same loss and gradients on every mesh
            cfg = bf16.train_config(base, arch)
            model = params_from_numpy(cfg, tree(inp, bf16.weights_key(arch)),
                                      device="cpu")
            params = dict(model.named_parameters())
            model.requires_grad_(True)
            loss, _ = zoo.loss_fn(model, cfg, {
                k: torch.from_numpy(inp[f"bf16_{arch}_{k}"])
                for k in ("tokens", "targets")})
            grads[arch] = (loss.item(), dict(zip(params, torch.autograd.grad(
                loss, list(params.values())))))
        loss, g = grads[arch]
        out[f"one{SEP}{tag}{SEP}loss"] = np.float64(loss)
        for name, v in g.items():
            out[f"one{SEP}{tag}{SEP}grad{SEP}{name}"] = full(v)
    for tag, arch, dims in serve:
        cfg = bf16.serve_config(base, shd, arch, dims)
        model = params_from_numpy(cfg, tree(inp, bf16.weights_key(arch)),
                                  device="cpu")
        with torch.no_grad():
            out[f"one{SEP}{tag}{SEP}tokens"] = greedy_generate(
                model, cfg, inp[f"bf16_{arch}_prompt"], max_new=bf16.NEW,
                device="cpu").numpy()
            out[f"one{SEP}{tag}{SEP}forced"] = forced_logits(model, cfg, inp,
                                                            arch)
    return out


def bf16_rows(inp, out):
    """The row-split projections in bf16 over ``model`` on 2x4, each
    rank's partial product summed in f32 and rounded once
    (``layers.dense_rows``): a projection with a bias, and the MLP (its
    ``gate``/``up`` columns, its ``down`` rows)."""
    from types import SimpleNamespace as NS

    from repro_torch.models.layers import dense_rows, mlp_apply

    mesh = init_mesh((2, 4), "cpu")
    with torch.no_grad(), use_sharding(TRAIN_RULES_1POD, mesh):
        g = parallel.axis_group("model")
        x = torch.from_numpy(inp["rows_x"]).bfloat16()

        def dense(name, dim):
            w = torch.from_numpy(inp[f"rows_{name}"]).bfloat16()
            return NS(w=parallel.local_slice(w, dim, g), b=None)

        p = dense("w", 0)
        p.b = torch.from_numpy(inp["rows_b"]).bfloat16()
        out["rows_dense"] = dense_rows(p, parallel.local_slice(x, -1, g),
                                       "bfloat16", g).float().numpy()
        mlp = NS(gate=dense("gate", 1), up=dense("up", 1),
                 down=dense("down", 0))
        out["rows_mlp"] = mlp_apply(mlp, x, "bfloat16",
                                    tp=g).float().numpy()


def _bf16_cases(families: bool):
    def run(inp, out, d):
        train, serve = bf16.cases(dist.get_world_size(), families)
        for case in train:
            bf16_train(inp, out, *case)
        for case in serve:
            bf16_serve(inp, out, *case)
        if dist.get_world_size() == 8 and not families:
            bf16_rows(inp, out)
    return run


#: the kinds of a collective op log, by index in the npz archives
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
COLL_B, COLL_S, COLL_LEN = 8, 16, 20


def _collective_steps(mesh, dev: str):
    """(tag, step, args, rules) of the steps whose collectives rank 0
    logs: reduced qwen2-72b trained in both policies, its prefill and one
    decode step with the cache placed by sequence, and reduced DeepSeek
    (MLA, MoE) trained; on ``cpu`` with weights and tokens from seed 0,
    on ``meta`` with their shapes."""
    from repro_torch.configs.base import ShapeSpec

    rng = np.random.default_rng(0)

    def batch(cfg, kind, s):
        specs = zoo.input_specs(cfg, ShapeSpec("c", kind, s, COLL_B))
        if dev == "meta":
            return specs
        return {k: torch.from_numpy(rng.integers(
            0, cfg.vocab, tuple(t.shape), dtype=np.int32))
            for k, t in specs.items()}

    def model(cfg, mode):
        m = zoo.init_model(cfg, 0, device=dev)
        return shd.shard_model(m, cfg, mesh, mode=mode)

    opt_cfg = AdamWConfig()
    steps = []
    dense = vocab_config("qwen2-72b")
    for mode in ("train", "dp_train"):
        m = model(dense, mode)
        rules = (TRAIN_RULES_1POD if mode == "train"
                 else dp_rules(mesh.axis_names))
        steps.append((f"dense_{mode}", make_train_step(dense, opt_cfg),
                      (m, init_opt_state(dict(m.named_parameters())),
                       batch(dense, "train", COLL_S)), rules))
    serve = dataclasses.replace(vocab_serve_config("qwen2-72b", 4),
                                kv_cache_shard="seq")
    m = model(serve, "serve")
    prefill = make_prefill_step(serve, COLL_LEN, device=dev)
    decode = make_decode_step(serve, device=dev)
    held = {}

    def serve_steps(m, first, nxt):
        _, held["caches"] = prefill(m, first)
        decode(m, held["caches"], nxt, COLL_S)

    steps.append(("seq_decode", serve_steps,
                  (m, batch(serve, "prefill", COLL_S),
                   batch(serve, "decode", COLL_S)), SERVE_RULES_1POD))
    mla = vocab_config("deepseek-v2-lite-16b")
    m = model(mla, "train")
    steps.append(("mla_train", make_train_step(mla, opt_cfg),
                  (m, init_opt_state(dict(m.named_parameters())),
                   batch(mla, "train", COLL_S)), TRAIN_RULES_1POD))
    return steps


def case_collectives(inp, out, d):
    """Rank 0's collectives, as ``StepCount`` logs them (kind, group
    size, result bytes), of each of ``_collective_steps`` on 2x4: in a
    gloo world on real tensors, in a fake one on ``meta``."""
    mesh = world_mesh((2, 4))
    dev = "meta" if FAKE_MESH is not None else "cpu"
    for tag, step, args, rules in _collective_steps(mesh, dev):
        with use_sharding(rules, mesh), StepCount() as count:
            step(*args)
        out[f"coll_{tag}"] = np.array(
            [(KINDS.index(k), g, b) for k, g, b in count.collective_ops],
            np.int64).reshape(-1, 3)


CASES = {"ring": case_ring, "moe": case_moe, "train": case_train,
         "train_tp": case_train_tp,
         "compress": case_compress, "ckpt_save": case_ckpt_save,
         "ckpt_restore": case_ckpt_restore, "decode": case_decode,
         "families_train": case_families_train,
         "families_serve": case_families_serve,
         "vocab_train": case_vocab_train, "vocab_serve": case_vocab_serve,
         "collectives": case_collectives, "bf16": _bf16_cases(False),
         "bf16_families": _bf16_cases(True)}


def fake_main() -> int:
    """``fake <world> <dir> <cases>``: rank 0 of a fake 2x4 world."""
    global FAKE_MESH
    world, d = int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    inp = np.load(os.path.join(d, "in.npz"))
    out: dict = {}
    with fake_world(Mesh(("data", "model"), (2, world // 2))) as mesh:
        FAKE_MESH = mesh
        for case in sys.argv[4].split(","):
            CASES[case](inp, out, d)
    np.savez(os.path.join(d, f"out_fake{world}.npz"), **out)
    return 0


def main() -> int:
    if sys.argv[1] == "fake":
        return fake_main()
    world, rank, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cases = sys.argv[4].split(",")
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, f"store_{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    inp = np.load(os.path.join(d, "in.npz"))
    out: dict = {}
    try:
        for case in cases:
            CASES[case](inp, out, d)
    except BaseException:  # noqa: BLE001
        print(f"rank {rank}: {traceback.format_exc()}", file=sys.stderr,
              flush=True)
        os._exit(1)
    if rank == 0:
        np.savez(os.path.join(d, f"out_{world}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
