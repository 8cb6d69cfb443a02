"""Serving launcher: batched prefill + decode driver.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --batch 8 --prompt-len 32 --max-new 32 [--device cpu]

Counterpart of the reference's ``launch/serve.py``, on one device: the
prefill and decode steps of ``repro_torch/serve/serve_step.py`` on
``--device`` (``cuda`` by default; without a CUDA device it exits 1).
Refused, because the port has no counterpart yet: ``--mesh`` (sharding,
ROADMAP queue 1 item 9), ``--kv-quant`` and ``--kv-shard seq`` (the int8
and the sequence-sharded KV caches, ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs.base import (get_config, make_serve_config,
                                      reduce_config)
from repro_torch.models import init_model
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

REFUSED = {
    "mesh": "--mesh: sharding is not ported; the port serves on one device "
            "(ROADMAP, queue 1 item 9, distributed/)",
    "kv_quant": "--kv-quant: the int8 KV cache is not ported (ROADMAP, "
                "queue 1 item 7)",
    "kv_shard": "--kv-shard seq: the sequence-sharded KV cache is not "
                "ported (ROADMAP, queue 1 item 7)",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mesh", default="", help="refused: not ported")
    ap.add_argument("--kv-quant", action="store_true",
                    help="refused: not ported")
    ap.add_argument("--kv-shard", default="heads", choices=["heads", "seq"],
                    help="heads (seq is refused: not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    for flag, given in (("mesh", args.mesh), ("kv_quant", args.kv_quant),
                        ("kv_shard", args.kv_shard == "seq")):
        if given:
            ap.error(REFUSED[flag])

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = make_serve_config(cfg, 1)
    print(f"serving {cfg.name}: kv_repeat={cfg.kv_repeat} "
          f"quant={cfg.kv_cache_quant} shard={cfg.kv_cache_shard}",
          flush=True)
    try:
        model = init_model(cfg, 0, device=args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"launch.serve: {e}", file=sys.stderr, flush=True)
        return 1
    dev = model.device
    max_len = args.prompt_len + args.max_new + 8
    prefill = make_prefill_step(cfg, max_len, device=dev)
    decode = make_decode_step(cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen).to(dev)
    with torch.no_grad():
        t0 = time.time()
        logits, caches = prefill(model, {"tokens": prompts})
        sync()
        t_prefill = time.time() - t0
        tok = torch.argmax(logits[:, -1:], -1)
        t0 = time.time()
        for i in range(args.max_new):
            logits, caches = decode(model, caches, {"tokens": tok},
                                    args.prompt_len + i)
            tok = torch.argmax(logits[:, -1:], -1)
        sync()
        t_dec = time.time() - t0
    print(f"prefill {args.batch}x{args.prompt_len} in {t_prefill:.2f}s; "
          f"decode {args.max_new} steps: "
          f"{args.batch * args.max_new / t_dec:.0f} tok/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
