"""One rank of the multi-rank CPU tests (``tests/test_torch_distributed.py``).

    python tests/_torch_dist_worker.py <world> <rank> <dir> <case,case,...>

Each rank joins a gloo world through a ``FileStore`` under ``<dir>``, reads
the inputs the test wrote (``<dir>/in.npz``: numpy arrays made from a seed,
and the reference's weights and results), runs the cases in order on the
port (``repro_torch``; this process imports neither JAX nor ``repro``),
and rank 0 writes what the test compares to ``<dir>/out_<world>.npz``.
A case that raises ends the rank with exit code 1, after printing its
traceback.
"""
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
from repro_torch.launch.mesh import init_mesh
from repro_torch.models import params_from_numpy, zoo
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_train_step

SEP = "|"  # stands for "/" in the names of the npz archives


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


CASES = {"ring": case_ring, "moe": case_moe, "train": case_train,
         "train_tp": case_train_tp,
         "compress": case_compress, "ckpt_save": case_ckpt_save,
         "ckpt_restore": case_ckpt_restore, "decode": case_decode}


def main() -> int:
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
