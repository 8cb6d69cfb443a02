"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --batch 8 --seq 128 [--reduced] [--device cuda|cpu] \\
        [--checkpoint-dir ckpt] [--resume] [--mesh D,M] [--layers N]
    torchrun --nproc-per-node N -m repro_torch.launch.train --mesh D,M ...

Counterpart of the reference's ``launch/train.py``, on one device: the
model trains on ``--device`` (``cuda`` by default; without a CUDA device it
exits 1, and ``--device cpu`` runs on the CPU, with ``--reduced`` at a
smoke size).  As the reference's, it feeds tokens only, so it trains
every family but the encoder-decoder and the VLM, whose losses need
frames or patch embeddings: it refuses those two (exit 2), where the
reference's fails at each step.  On a card the random weights are drawn there
from a CUDA generator seeded with 0 (as ``launch.serve`` draws them): a
host draw of a full-width model takes a while.  The loop is the
fault-tolerant one from
``repro_torch/train/elastic.py``: async checkpoints, crash-restart,
straggler-tolerant prefetch.  Params are bf16 with an f32 master copy in
the optimizer state, as the reference sets them.

``--mesh D,M`` (the reference's format: data, model) trains on a mesh over
the ranks of the run (``launch.mesh.init_mesh``: under ``torchrun
--nproc-per-node N``, or one rank alone; NCCL on a card, gloo with
``--device cpu``), as the reference does: ``choose_policy`` picks
``dp_train`` (FSDP over every axis, ``dp_rules``) or ``train`` (FSDP over
``data``, tensor parallelism over ``model``, ``TRAIN_RULES_1POD``), the
parameters and so the optimizer state are placed by ``shard_model`` in
that mode, and each rank trains on its rows of every batch.  On one card
the mesh is 1x1.  Every family it trains takes a mesh of any size whose
axes divide as the reference's specs need (under ``train``, the SSM and
hybrid mixers over their channels or heads and Zamba2's shared block
over ``model`` as well: ``distributed/parallel.py``).  Rank 0 prints and
writes the checkpoints.  ``--layers N`` trains the config's first N
layers at its published widths (a cut of depth, as a smoke run makes
it).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import tempfile

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.launch import (cut_depth, init_on_device, printer,
                                setup_mesh)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import PrefetchPipeline, synthetic_token_batches
from repro_torch.train.elastic import LoopConfig, recoverable_train_loop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

#: why the launcher refuses the encoder-decoder and the VLM
FRONTEND_REFUSED = (
    "{} ({}): the launcher feeds tokens only, as the reference's, and this "
    "family's loss needs {}; train it with make_train_step on batches "
    "that carry them")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU)")
    ap.add_argument("--mesh", default="", help="e.g. 2,4 for (data,model)")
    ap.add_argument("--layers", type=int, default=0,
                    help="train the config's first N layers (0: all)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.is_encdec or cfg.frontend == "patch":
        ap.error(FRONTEND_REFUSED.format(
            cfg.name, cfg.family,
            "frames" if cfg.is_encdec else "patch embeddings"))
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cut_depth(ap, cfg, args.layers)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    mesh = setup_mesh(ap, args, "launch.train")
    if mesh is False:
        return 1
    model = init_on_device(cfg, args.device, "launch.train")
    if model is None:
        return 1
    say = printer(mesh)
    scope = contextlib.nullcontext
    if mesh is not None:
        from repro_torch.distributed import sharding as shd
        from repro_torch.distributed.ctx import (TRAIN_RULES,
                                                 TRAIN_RULES_1POD, dp_rules,
                                                 use_sharding)

        mode = shd.choose_policy(cfg, mesh, "train")
        shd.shard_model(model, cfg, mesh, mode=mode)
        rules = (dp_rules(tuple(mesh.axis_names)) if mode == "dp_train"
                 else TRAIN_RULES if "pod" in mesh.axis_names
                 else TRAIN_RULES_1POD)
        scope = lambda: use_sharding(rules, mesh)  # noqa: E731
        say(f"mesh {mesh.shape} on {mesh.device_mesh.device_type} "
            f"policy {mode}")
    say(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
        f"device={model.device}")

    opt = init_opt_state(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    def step_fn(state, batch):
        model, opt = state
        with scope():
            model, opt, metrics = step(model, opt, batch)
        return (model, opt), metrics

    pipe = PrefetchPipeline(
        synthetic_token_batches(cfg.vocab, args.batch, args.seq,
                                n_batches=args.steps * 2),
        depth=4, deadline_s=10.0)

    ckdir = args.checkpoint_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    if mesh is not None:  # rank 0's directory, where it writes
        import torch.distributed as dist

        shared = [ckdir]
        dist.broadcast_object_list(shared, src=0)
        ckdir = shared[0]
    ckpt = CheckpointManager(ckdir, keep=2)
    state = (model, opt)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state)
        start = extra.get("step", 0)
        say(f"resumed from step {start}")

    def on_metrics(s, m):
        if s % 10 == 0 or s == args.steps:
            say(f"step {s:5d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m.get('grad_norm', 0)):.2f}")

    state, steps, restarts = recoverable_train_loop(
        state, pipe, step_fn, ckpt=ckpt,
        cfg=LoopConfig(total_steps=args.steps,
                       checkpoint_every=args.checkpoint_every),
        start_step=start, on_metrics=on_metrics)
    pipe.close()
    say(f"done: {steps} steps, restarts={restarts}, checkpoints in {ckdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
