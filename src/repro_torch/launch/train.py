"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --batch 8 --seq 128 [--reduced] [--device cuda|cpu] \\
        [--checkpoint-dir ckpt] [--resume]

Counterpart of the reference's ``launch/train.py``, on one device: the
model trains on ``--device`` (``cuda`` by default; without a CUDA device it
exits 1, and ``--device cpu`` runs on the CPU, with ``--reduced`` at a
smoke size).  The loop is the fault-tolerant one from
``repro_torch/train/elastic.py``: async checkpoints, crash-restart,
straggler-tolerant prefetch.  Params are bf16 with an f32 master copy in
the optimizer state, as the reference sets them.  ``--mesh`` is refused:
sharding (the reference's ``distributed/``) is not ported (ROADMAP,
queue 1 item 9).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import init_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import PrefetchPipeline, synthetic_token_batches
from repro_torch.train.elastic import LoopConfig, recoverable_train_loop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

MESH_REFUSED = ("--mesh: sharding is not ported; the port trains on one "
                "device (ROADMAP, queue 1 item 9, distributed/)")


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
    ap.add_argument("--mesh", default="", help="refused: not ported")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error(MESH_REFUSED)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    try:
        model = init_model(cfg, 0, device=args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"launch.train: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={model.device}", flush=True)

    opt = init_opt_state(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    def step_fn(state, batch):
        model, opt = state
        model, opt, metrics = step(model, opt, batch)
        return (model, opt), metrics

    pipe = PrefetchPipeline(
        synthetic_token_batches(cfg.vocab, args.batch, args.seq,
                                n_batches=args.steps * 2),
        depth=4, deadline_s=10.0)

    ckdir = args.checkpoint_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    ckpt = CheckpointManager(ckdir, keep=2)
    state = (model, opt)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state)
        start = extra.get("step", 0)
        print(f"resumed from step {start}", flush=True)

    def on_metrics(s, m):
        if s % 10 == 0 or s == args.steps:
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m.get('grad_norm', 0)):.2f}", flush=True)

    state, steps, restarts = recoverable_train_loop(
        state, pipe, step_fn, ckpt=ckpt,
        cfg=LoopConfig(total_steps=args.steps,
                       checkpoint_every=args.checkpoint_every),
        start_step=start, on_metrics=on_metrics)
    pipe.close()
    print(f"done: {steps} steps, restarts={restarts}, checkpoints in {ckdir}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
