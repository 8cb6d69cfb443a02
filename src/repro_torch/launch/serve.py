"""Serving launcher: batched prefill + decode driver.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --batch 8 --prompt-len 32 --max-new 32 [--kv-quant] \\
        [--device cpu]

Counterpart of the reference's ``launch/serve.py``, on one device: the
prefill and decode steps of ``repro_torch/serve/serve_step.py`` on
``--device`` (``cuda`` by default; without a CUDA device it exits 1).
The dense, MoE (DeepSeek's MLA included), SSM, hybrid and VLM families
serve (``--arch qwen3-moe-30b-a3b`` at full width takes 61 GB of bf16
weights on one 80 GB card, ``internvl2-26b`` 39.8 GB,
``deepseek-v2-lite-16b`` 31.4 GB, ``falcon-mamba-7b`` 14.5 GB,
``zamba2-1.2b`` 2.6 GB), with ``--kv-quant`` on the int8 KV cache; the
VLM takes text prompts, as in the reference.  The encoder-decoder family
(``seamless-m4t-medium``) is refused: the reference's launcher passes no
``enc_out``, which its decode step needs (serve it through
``repro_torch.serve``).  On a CUDA device the random weights are drawn there, from a CUDA
generator seeded with 0.  Refused, because the port has no counterpart
yet: ``--mesh`` and ``--kv-shard seq`` (sharding, and the cache's
sequence axis placed over a mesh: ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs.base import (get_config, make_serve_config,
                                      reduce_config)
from repro_torch.launch import init_on_device
from repro_torch.serve.batching import ENCDEC_REFUSED
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

REFUSED = {
    "mesh": "--mesh: sharding is not ported; the port serves on one device "
            "(ROADMAP, queue 1 item 9, distributed/)",
    "kv_shard": "--kv-shard seq: the sequence-sharded KV cache is not "
                "ported; it places the cache over a mesh (ROADMAP, queue 1 "
                "item 9, distributed/)",
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
                    help="int8 KV cache")
    ap.add_argument("--kv-shard", default="heads", choices=["heads", "seq"],
                    help="heads (seq is refused: not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    for flag, given in (("mesh", args.mesh),
                        ("kv_shard", args.kv_shard == "seq")):
        if given:
            ap.error(REFUSED[flag])

    cfg = get_config(args.arch)
    if cfg.is_encdec:
        ap.error(ENCDEC_REFUSED.format(cfg.name))
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = dataclasses.replace(cfg, kv_cache_quant=args.kv_quant)
    cfg = make_serve_config(cfg, 1)
    print(f"serving {cfg.name}: kv_repeat={cfg.kv_repeat} "
          f"quant={cfg.kv_cache_quant} shard={cfg.kv_cache_shard}",
          flush=True)
    t0 = time.time()
    model = init_on_device(cfg, args.device, "launch.serve")
    if model is None:
        return 1
    dev = model.device
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init {n_params} parameters on {dev} in {time.time() - t0:.2f}s",
          flush=True)
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
