"""Iteration-level batched serving on the PyTorch/CUDA port: the flow of
``examples/continuous_batching.py`` on ``repro_torch``.  Requests of
different lengths share decode steps in the ``ContinuousBatcher``; early
finishers retire while the wave drains; TTFT/latency/throughput are
reported, at the reference example's reduced smollm-135m widths (4
layers, d_model 192, 6 heads of 32 on 3).

    PYTHONPATH=src python examples/continuous_batching_torch.py
    PYTHONPATH=src python examples/continuous_batching_torch.py --device cpu

``--device`` is ``cuda`` by default: the weights are drawn there, from a
CUDA generator seeded with 0, and each wave's prefill runs the
``flash_attention`` kernel once per layer.  The script exits 1 without a
CUDA device, and exits 1 if a request does not finish or a logit is not
finite.  :func:`run` is the whole flow, importable as it is; it returns
the contracts by name.
"""
import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.configs.base import get_config, make_serve_config
from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models import decode_step, init_cache, init_model
from repro_torch.serve import ContinuousBatcher

N_REQUESTS = 10


def config():
    cfg = dataclasses.replace(get_config("smollm-135m"), n_layers=4,
                              d_model=192, n_heads=6, n_kv_heads=3,
                              head_dim=32, d_ff=512, vocab=2048)
    return make_serve_config(cfg, model_axis=1)


@torch.no_grad()
def run(device: str = "cuda") -> dict:
    """Ten requests through the batcher on ``device``; returns the
    contracts (each should be True) by name."""
    dev = resolve_device(device)
    cfg = config()
    gen = (torch.Generator(device=dev).manual_seed(0) if dev.type == "cuda"
           else 0)
    model = init_model(cfg, gen, device=dev)

    batcher = ContinuousBatcher(cfg, model, slots=4, max_len=128,
                                device=dev)
    rng = np.random.default_rng(0)
    for _ in range(N_REQUESTS):
        plen = int(rng.integers(8, 24))
        batcher.submit(rng.integers(0, cfg.vocab, plen).astype(np.int32),
                       max_new=int(rng.integers(8, 20)))

    stats = batcher.run_until_drained()
    print("served:", stats)
    for r in batcher.finished[:3]:
        print(f"  req {r.rid}: prompt {len(r.prompt)} -> "
              f"{len(r.out_tokens)} new tokens, ttft "
              f"{1e3 * (r.first_token_at - r.submitted_at):.0f} ms")
    # the first request's prompt and continuation, prefilled again: the
    # logits of the last position are finite
    r = batcher.finished[0]
    seq = torch.from_numpy(np.concatenate(
        [r.prompt, np.asarray(r.out_tokens)]).astype(np.int64))[None]
    logits, _ = decode_step(model, cfg, {"tokens": seq.to(dev)},
                            init_cache(cfg, 1, seq.shape[1], device=dev),
                            cache_index=0)
    finite = bool(torch.isfinite(logits).all())
    print(f"request {r.rid} prefilled again: logits finite: {finite}")
    return {"all_served": stats["requests"] == N_REQUESTS and all(
                len(r.out_tokens) >= r.max_new for r in batcher.finished),
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
        print(f"continuous_batching_torch: {e}", file=sys.stderr)
        return 1
    ok = run(args.device)
    failed = sorted(k for k, v in ok.items() if not v)
    print(f"contracts: {len(ok) - len(failed)} of {len(ok)} hold"
          + (f"; failed: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
