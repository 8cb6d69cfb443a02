"""Model smoke on the PyTorch/CUDA port: the flow of
``scripts/smoke_models.py`` on ``repro_torch``.  One forward/loss and one
decode step for every architecture of ``repro_torch.configs.base.ARCH_IDS``
at ``reduce_config`` size.

    PYTHONPATH=src python scripts/smoke_models_torch.py [ARCH ...]
    PYTHONPATH=src python scripts/smoke_models_torch.py --device cpu

``--device`` is ``cuda`` by default: the weights are drawn there, from a
CUDA generator seeded with 42, and every attention of the forward runs
the ``flash_attention`` kernel.  The kernel takes head widths of 32, 64
and 128 (and MLA's q.k 192 over v 128), so the reduced configs' heads of
16 are widened to 32, and MLA's to its published 128 + 64 and 128; the
CPU runs the same configs.  The script exits 1 without a CUDA device, and
exits 1 if a loss or a logit is not finite or a shape is wrong.
:func:`smoke` is one architecture, importable as it is.
"""
import argparse
import dataclasses
import sys

import torch

from repro_torch.configs.base import ARCH_IDS, get_config, reduce_config
from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models import zoo

#: the narrowest head width the attention kernel takes
HEAD_DIM = 32


def smoke_config(arch: str):
    """``reduce_config`` of ``arch`` with head widths the kernel takes."""
    cfg = reduce_config(get_config(arch))
    kw = {"head_dim": HEAD_DIM}
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, qk_nope_head_dim=128,
                                        qk_rope_head_dim=64,
                                        v_head_dim=128)
    return dataclasses.replace(cfg, **kw)


def fake_batch(cfg, dev, B=2, S=64, seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)

    def ints(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=g).to(dev)

    def floats(*shape):
        return torch.randn(shape, generator=g).to(dev)

    if cfg.frontend == "patch":
        n_img = min(cfg.frontend_tokens, S // 4)
        return {"patch_embeds": floats(B, n_img, cfg.frontend_dim),
                "tokens": ints(B, S - n_img), "targets": ints(B, S - n_img)}
    if cfg.is_encdec:
        return {"frames": floats(B, S // 4, cfg.d_model),
                "tokens": ints(B, S), "targets": ints(B, S)}
    return {"tokens": ints(B, S), "targets": ints(B, S)}


@torch.no_grad()
def smoke(arch: str, device: str = "cuda") -> dict:
    """One loss and one decode step of ``arch`` on ``device``: the loss,
    whether every value was finite and the logits' shape right."""
    dev = resolve_device(device)
    cfg = smoke_config(arch)
    gen = (torch.Generator(device=dev).manual_seed(42) if dev.type == "cuda"
           else 42)
    model = zoo.init_model(cfg, gen, device=dev)
    loss, _ = zoo.loss_fn(model, cfg, fake_batch(cfg, dev))

    # decode one token
    B, max_len = 2, 64
    caches = zoo.init_cache(cfg, B, max_len, device=dev)
    dbatch = {"tokens": torch.zeros((B, 1), dtype=torch.long, device=dev)}
    if cfg.is_encdec:
        dbatch["enc_out"] = torch.zeros((B, 16, cfg.d_model), device=dev)
    logits, _ = zoo.decode_step(model, cfg, dbatch, caches, cache_index=3)
    ok = (bool(torch.isfinite(loss)) and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (B, 1, cfg.vocab))
    return {"loss": float(loss), "ok": ok,
            "params": zoo.analytic_param_count(cfg)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="*", help=f"default: all of {ARCH_IDS}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"smoke_models_torch: {e}", file=sys.stderr)
        return 1
    bad = []
    for arch in args.arch or ARCH_IDS:
        out = smoke(arch, args.device)
        print(f"{'OK' if out['ok'] else 'FAIL'} {arch:26s} "
              f"loss={out['loss']:8.4f} params={out['params']:,}")
        if not out["ok"]:
            bad.append(arch)
    print("ALL OK" if not bad else f"FAILED: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
