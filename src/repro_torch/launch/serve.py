"""Serving launcher: batched prefill + decode driver.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --batch 8 --prompt-len 32 --max-new 32 [--kv-quant] \\
        [--mesh 2,2 [--kv-shard seq]] [--device cpu]

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
generator seeded with 0.

``--mesh D,M`` (the reference's format: data, model) serves on a mesh
over the ranks of the run (``launch.mesh.init_mesh``: under ``torchrun
--nproc-per-node N``, or one rank alone; NCCL on a card, gloo with
``--device cpu``), as the reference does: ``make_serve_config`` for the
model axis, the parameters placed by ``shard_model(..., mode="serve")``,
the caches by ``cache_pspec`` (``--kv-shard seq`` splits their sequence
axis over ``model``), under ``SERVE_RULES_1POD``.  On one card the mesh is
1x1.  A mesh of more than one rank serves the dense and MoE families;
the others are refused there (ROADMAP queue 1 item 9, what is left of
it).  Rank 0 prints; the last line gives a digest of the generated
tokens, the same for every mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import sys
import time

import torch

from repro_torch.configs.base import (get_config, make_serve_config,
                                      reduce_config)
from repro_torch.launch import init_on_device, printer, setup_mesh
from repro_torch.serve.batching import ENCDEC_REFUSED
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mesh", default="", help="e.g. 2,2 for (data,model)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache")
    ap.add_argument("--kv-shard", default="heads", choices=["heads", "seq"],
                    help="the cache's placement over the model axis")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.is_encdec:
        ap.error(ENCDEC_REFUSED.format(cfg.name))
    if args.reduced:
        cfg = reduce_config(cfg)
    mesh = setup_mesh(ap, args, cfg, "launch.serve")
    if mesh is False:
        return 1
    model_axis = mesh.shape.get("model", 1) if mesh is not None else 1
    if mesh is not None and args.batch % (mesh.size // model_axis):
        ap.error(f"--batch {args.batch} does not divide over the mesh's "
                 f"{mesh.size // model_axis} batch ranks")
    cfg = make_serve_config(cfg, model_axis)
    cfg = dataclasses.replace(cfg, kv_cache_quant=args.kv_quant,
                              kv_cache_shard=args.kv_shard)
    say = printer(mesh)
    say(f"serving {cfg.name}: kv_repeat={cfg.kv_repeat} "
        f"quant={cfg.kv_cache_quant} shard={cfg.kv_cache_shard}")
    t0 = time.time()
    model = init_on_device(cfg, args.device, "launch.serve")
    if model is None:
        return 1
    dev = model.device
    n_params = sum(p.numel() for p in model.parameters())
    scope = contextlib.nullcontext()
    if mesh is not None:
        from repro_torch.distributed.ctx import (SERVE_RULES,
                                                 SERVE_RULES_1POD,
                                                 use_sharding)
        from repro_torch.distributed.sharding import shard_model

        shard_model(model, cfg, mesh, mode="serve")
        scope = use_sharding(SERVE_RULES if "pod" in mesh.axis_names
                             else SERVE_RULES_1POD, mesh)
        say(f"mesh {mesh.shape} on {mesh.device_mesh.device_type}")
    say(f"init {n_params} parameters on {dev} in {time.time() - t0:.2f}s")
    max_len = args.prompt_len + args.max_new + 8
    prefill = make_prefill_step(cfg, max_len, device=dev)
    decode = make_decode_step(cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen).to(dev)
    with torch.no_grad(), scope:
        t0 = time.time()
        logits, caches = prefill(model, {"tokens": prompts})
        sync()
        t_prefill = time.time() - t0
        tok = torch.argmax(logits[:, -1:], -1)
        new = [tok]
        t0 = time.time()
        for i in range(args.max_new):
            logits, caches = decode(model, caches, {"tokens": tok},
                                    args.prompt_len + i)
            tok = torch.argmax(logits[:, -1:], -1)
            new.append(tok)
        sync()
        t_dec = time.time() - t0
    say(f"prefill {args.batch}x{args.prompt_len} in {t_prefill:.2f}s; "
        f"decode {args.max_new} steps: "
        f"{args.batch * args.max_new / t_dec:.0f} tok/s")
    tokens = torch.cat(new, dim=1).to("cpu", torch.int64).numpy()
    say(f"tokens {tokens.shape[0]}x{tokens.shape[1]} sha256="
        f"{hashlib.sha256(tokens.tobytes()).hexdigest()[:16]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
