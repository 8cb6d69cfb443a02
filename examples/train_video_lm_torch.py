"""End-to-end training driver of the PyTorch/CUDA port: the flow of
``examples/train_video_lm.py`` on ``repro_torch``.  Trains a smollm-family
LM with the port's stack: the straggler-tolerant prefetch, AdamW, the
fault-tolerant checkpointing loop with a simulated node failure, and
recovery; then checks that the loss fell.

    PYTHONPATH=src python examples/train_video_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_video_lm_torch.py --device cpu \\
        --steps 60 --fail-at 30

The model is smollm-135m at published size when --full is passed; the
default trims layers and widths (as the reference example does) so a few
hundred steps fit a short run.  ``--device`` is ``cuda`` by default and the
script exits 1 without a CUDA device.
"""
import argparse
import dataclasses
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.models import init_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import PrefetchPipeline, synthetic_token_batches
from repro_torch.train.elastic import LoopConfig, recoverable_train_loop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="published smollm-135m size")
    ap.add_argument("--fail-at", type=int, default=120,
                    help="simulate a node failure at this step (0=off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=256, n_heads=8,
                                  n_kv_heads=4, head_dim=32, d_ff=1024,
                                  vocab=8192, loss_chunk=2048)
    n = cfg.param_count()
    print(f"model: {cfg.name}  params={n / 1e6:.1f}M  layers={cfg.n_layers}")

    try:
        model = init_model(cfg, 0, device=args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"train_video_lm_torch: {e}", file=sys.stderr)
        return 1
    opt = init_opt_state(dict(model.named_parameters()))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    raw_step = make_train_step(cfg, opt_cfg)

    def step_fn(state, batch):
        model, opt = state
        model, opt, metrics = raw_step(model, opt, batch)
        return (model, opt), metrics

    source = synthetic_token_batches(cfg.vocab, args.batch, args.seq,
                                     n_batches=args.steps * 2)
    pipe = PrefetchPipeline(source, depth=4, deadline_s=5.0)

    faults = {"armed": args.fail_at > 0}

    def fault_hook(step):
        if faults["armed"] and step == args.fail_at:
            faults["armed"] = False
            raise RuntimeError("simulated node failure")

    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m.get('lr', 0)):.2e}")

    with tempfile.TemporaryDirectory() as ckdir:
        ckpt = CheckpointManager(ckdir, keep=2)
        t0 = time.time()
        (model, opt), steps, restarts = recoverable_train_loop(
            (model, opt), pipe, step_fn, ckpt=ckpt,
            cfg=LoopConfig(total_steps=args.steps, checkpoint_every=50),
            fault_hook=fault_hook, on_metrics=on_metrics)
        dt = time.time() - t0
    pipe.close()

    print(f"\ndone: {steps} steps in {dt:.1f}s "
          f"({args.batch * args.seq * steps / dt:.0f} tok/s), "
          f"restarts={restarts}, prefetch stats={pipe.stats}")
    print(f"loss: first={losses[0]:.3f} last={np.mean(losses[-10:]):.3f}")
    assert np.mean(losses[-10:]) < losses[0], "loss must decrease"
    return 0


if __name__ == "__main__":
    sys.exit(main())
