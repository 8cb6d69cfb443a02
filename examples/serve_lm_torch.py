"""Batched LM serving on the PyTorch/CUDA port: the flow of
``examples/serve_lm.py`` on ``repro_torch``.  Prefill a batch of prompts,
then decode with the layer-stacked KV cache, at the reference example's
reduced smollm-135m widths (6 layers, d_model 256, 8 heads of 32 on 4).

    PYTHONPATH=src python examples/serve_lm_torch.py
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

``--device`` is ``cuda`` by default: the weights are drawn there, from a
CUDA generator seeded with 1, and each prefill's attention runs the
``flash_attention`` kernel once per layer.  The script exits 1 without a
CUDA device, and exits 1 if a logit is not finite.  :func:`run` is the
whole flow, importable as it is; it returns the contracts by name.
"""
import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs.base import get_config, make_serve_config
from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models import init_model
from repro_torch.serve import (greedy_generate, make_decode_step,
                               make_prefill_step)

B, S0, NEW, STEADY = 8, 32, 48, 64


def config():
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=6,
                              d_model=256, n_heads=8, n_kv_heads=4,
                              head_dim=32, d_ff=1024, vocab=4096)
    return make_serve_config(cfg, model_axis=1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def run(device: str = "cuda") -> dict:
    """Greedy generation, then steady decode, on ``device``; returns the
    contracts (each should be True) by name."""
    dev = resolve_device(device)
    cfg = config()
    gen = (torch.Generator(device=dev).manual_seed(1) if dev.type == "cuda"
           else 1)
    model = init_model(cfg, gen, device=dev)
    print(f"serving {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"kv_repeat={cfg.kv_repeat}, on {dev}")

    # a batch of 8 requests, prompt length 32
    prompts = torch.randint(0, cfg.vocab, (B, S0),
                            generator=torch.Generator().manual_seed(2))
    t0 = time.time()
    out = greedy_generate(model, cfg, prompts, max_new=NEW, device=dev)
    _sync(dev)
    dt = time.time() - t0
    print(f"generated {B}x{NEW} tokens in {dt:.2f}s "
          f"({B * NEW / dt:.0f} tok/s incl. prefill)")
    print("sample continuation ids:", out[0][:16].cpu().numpy())

    # steady-state decode throughput, after a prefill of the prompts and
    # their continuations
    prefill = make_prefill_step(cfg, S0 + NEW + STEADY + 8, device=dev)
    step = make_decode_step(cfg, device=dev)
    logits, caches = prefill(model, {"tokens": torch.cat(
        [prompts.to(dev), out], dim=1)})
    finite = bool(torch.isfinite(logits).all())
    _sync(dev)
    t0 = time.time()
    idx = S0 + NEW
    for i in range(STEADY):
        logits, caches = step(model, caches,
                              {"tokens": torch.argmax(logits[:, -1:], -1)},
                              idx + i)
        finite &= bool(torch.isfinite(logits).all())
    _sync(dev)
    dt = time.time() - t0
    print(f"steady-state decode: {STEADY * B / dt:.0f} tok/s "
          f"({dt / STEADY * 1e3:.1f} ms/step at batch {B}), "
          f"logits finite: {finite}")
    return {"tokens_shape": tuple(out.shape) == (B, NEW),
            "logits_finite": finite}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"serve_lm_torch: {e}", file=sys.stderr)
        return 1
    ok = run(args.device)
    failed = sorted(k for k, v in ok.items() if not v)
    print(f"contracts: {len(ok) - len(failed)} of {len(ok)} hold"
          + (f"; failed: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
