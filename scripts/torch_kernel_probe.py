#!/usr/bin/env python3
"""Card probe of the port's two redesigned kernels, ``flash_attention``
(bf16 on tensor cores) and ``decode_gop_blocks`` (warp-level).

    python3 scripts/torch_kernel_probe.py [--baseline DIR] [--seeds 0 1 2 3]

From the root of a checkout, on a machine with a CUDA device and ``nvcc``:

1. prints the card's name and power limit, and what ``nvcc -Xptxas -v``
   says of every kernel of the two sources (registers, shared memory,
   spills);
2. with ``--baseline DIR``, a tree holding another version's
   ``src/repro_torch/kernels/{decode,flash_attention}/csrc/*.cu`` (for
   example ``git archive <commit> src/repro_torch/kernels | tar -x -C
   DIR``): builds those sources too, checks that both versions of
   ``decode_gop_blocks`` give bit-identical output at ragged and full
   shapes, and times both versions of each kernel at the main path's shapes
   in turns (baseline, current, current, baseline), with SDPA beside the
   attention and the decode's achieved GB/s beside its byte bound;
3. per seed, the bf16 prefill of full-width ``smollm-135m`` (B=8, S=512,
   random weights from the seed): the largest difference of the last
   position's logits from those of the plain-attention model, with the
   kernel, with the baseline's kernel, and with the plain emulations of the
   kernel's bf16 rounding (``attention_bf16_mma_ref``: P split into two
   bf16 parts, and P rounded to bf16 alone).

Imports neither JAX nor the reference package.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.decode import build as dbuild  # noqa: E402
from repro_torch.kernels.decode import decode_gop_blocks  # noqa: E402
from repro_torch.kernels.flash_attention import flash as fmod  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bf16_mma_ref, attention_ref)

DECODE_SHAPES = [(1, 1), (2, 3), (17, 5), (16, 33), (3, 65), (16, 777),
                 (16, 32768)]


def ptxas_report(source: pathlib.Path) -> None:
    out = ROOT / "build" / "probe" / f"{source.stem}_ptxas.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(out), str(source)],
                          capture_output=True, text=True, check=True)
    print(f"ptxas {source.name}:")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            print("  " + line.split("'")[1])
        elif "Used" in line or "spill" in line:
            print("    " + line.split("ptxas info", 1)[-1].strip(" :"))


def baseline_libraries(tree: pathlib.Path) -> dict:
    kernels = tree / "src" / "repro_torch" / "kernels"
    libs = {
        "decode": kbuild.CudaLibrary(
            kernels / "decode" / "csrc" / dbuild.SOURCE.name, dbuild._bind),
        "flash": kbuild.CudaLibrary(
            kernels / "flash_attention" / "csrc" / fmod.SOURCE.name,
            fmod._bind)}
    for lib in libs.values():
        lib.build()
    return libs


def in_turns(name: str, fn, base, time_one) -> dict:
    """``time_one()`` under the baseline library, the current one twice,
    then the baseline again; ``fn(lib)`` patches a library in."""
    times = {"baseline": [], "current": []}
    for tag in ("baseline", "current", "current", "baseline"):
        with fn(base if tag == "baseline" else None):
            times[tag].append(time_one())
    print(f"{name}: " + "; ".join(
        f"{tag} {' / '.join(f'{t:.6f}' for t in ts)} ms"
        for tag, ts in times.items()), flush=True)
    return times


def decode_versions(base) -> None:
    def patched(lib):
        return mock.patch.object(dbuild, "LIBRARY", lib or dbuild.LIBRARY)

    rng = np.random.default_rng(0)
    for f, m in DECODE_SHAPES:
        q = torch.from_numpy(cs.random_stream(rng, f, m, cs.QP)).cuda()
        new = decode_gop_blocks(q, cs.QP)
        with patched(base):
            old = decode_gop_blocks(q, cs.QP)
        torch.cuda.synchronize()
        cs.check(torch.equal(new, old), f"decode F={f} M={m}: the two "
                                        f"versions differ")
    print(f"decode_gop_blocks: bit-identical to the baseline at (F, M) in "
          f"{DECODE_SHAPES}", flush=True)
    f, m = 16, 32768
    q = torch.from_numpy(cs.random_stream(rng, f, m, cs.QP)).cuda()
    b_ms, _ = cs.bound_ms(f * m, cs.BYTES_PER_BLOCK_FRAME,
                          cs.FLOPS_PER_BLOCK_FRAME)
    times = in_turns(f"decode_gop_blocks F={f} M={m} (bound {b_ms:.6f} ms)",
                     patched, base,
                     lambda: cs.cuda_ms(lambda: decode_gop_blocks(q, cs.QP),
                                        iters=50))
    for tag, ts in times.items():
        t = min(ts)
        print(f"  {tag}: {f * m * cs.BYTES_PER_BLOCK_FRAME / t / 1e6:.1f} "
              f"GB/s, {b_ms / t:.3f} of the bound", flush=True)


def flash_versions(base) -> None:
    def patched(lib):
        return mock.patch.object(fmod, "LIBRARY", lib or fmod.LIBRARY)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(1)
    for shape in (cs.FLASH_MAIN, cs.FLASH_LONG):
        q, k, v = cs._qkv(rng, *shape, torch.bfloat16)
        b_ms, b_by = cs.flash_bound_ms(shape, torch.bfloat16, True)
        in_turns(f"flash_attention {shape} bf16 causal (bound {b_ms:.6f} ms, "
                 f"{b_by})", patched, base,
                 lambda: cs.cuda_ms(lambda: fmod.flash_attention(q, k, v),
                                    iters=20))
        l_ms = cs.cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                       enable_gqa=True), iters=20)
        print(f"  sdpa: {l_ms:.6f} ms", flush=True)


def logits_margins(seed: int, base) -> None:
    from repro_torch.models import attention, init_model
    from repro_torch.serve import make_prefill_step

    cfg = cs._serve_config()
    model = init_model(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed + 3)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (cs.SERVE_B, cs.SERVE_S))).cuda()
    prefill = make_prefill_step(cfg, cs.SERVE_S + cs.SERVE_NEW,
                                device="cuda")

    def logits(attn=None, lib=None):
        with torch.no_grad(), \
                mock.patch.object(fmod, "LIBRARY", lib or fmod.LIBRARY):
            if attn is None:
                out, _ = prefill(model, {"tokens": prompts})
            else:
                with mock.patch.object(attention, "flash_attention_op",
                                       attn):
                    out, _ = prefill(model, {"tokens": prompts})
        return out.float()

    plain = logits(lambda q, k, v, causal=True:
                   attention_ref(q, k, v, causal=causal))
    runs = {"kernel": logits()}
    if base is not None:
        runs["baseline kernel"] = logits(lib=base)
    for name, split in (("emulation, P_hi + P_lo", True),
                        ("emulation, P_hi alone", False)):
        runs[name] = logits(lambda q, k, v, causal=True, split=split:
                            attention_bf16_mma_ref(q, k, v, causal=causal,
                                                   split_p=split))
    print(f"bf16 prefill logits, seed {seed}, max |diff| from the plain "
          f"attention (gate {cs.LOGITS_ATOL[torch.bfloat16]}): " +
          "; ".join(f"{n} {float((x - plain).abs().max()):.6g}"
                    for n, x in runs.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for source in (fmod.SOURCE, dbuild.SOURCE):
        ptxas_report(source)
    cs.build_all()
    base = baseline_libraries(args.baseline) if args.baseline else None
    if base is not None:
        decode_versions(base["decode"])
        flash_versions(base["flash"])
    for seed in args.seeds:
        logits_margins(seed, base["flash"] if base else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
