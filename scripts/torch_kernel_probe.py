#!/usr/bin/env python3
"""Card probe of the port's redesigned kernels: ``flash_attention`` (bf16
on tensor cores), ``decode_gop_blocks``, ``dct_quant`` and
``idct_dequant`` (warp-level).

    python3 scripts/torch_kernel_probe.py [--baseline DIR] [--seeds 0 1 2 3]

From the root of a checkout, on a machine with a CUDA device and ``nvcc``:

1. prints the card's name and power limit, and what ``nvcc -Xptxas -v``
   says of every kernel of the four sources (registers, shared memory,
   stack frame, spills);
2. times a 1-element ``add_`` as the encode kernels are timed (what the
   warm and the L2-cold timing cost a kernel that does next to nothing);
   ``dct_quant`` and ``idct_dequant`` against a build of their sources with
   one round of 4 blocks per warp (the grid covering N, its cap taken
   out) in place of the capped grid whose warps loop over rounds, in
   turns, warm and L2-cold, at N=32,400 and 131,072; and both back to back
   over rotating inputs larger than the L2 cache;
3. with ``--baseline DIR``, a tree holding another version's
   ``src/repro_torch/kernels/*/csrc/*.cu`` (for example ``git archive
   <commit> src/repro_torch/kernels | tar -x -C DIR``): builds those
   sources too, checks that both versions of ``decode_gop_blocks``,
   ``dct_quant`` and ``idct_dequant`` give bit-identical output at ragged
   and full shapes (the encode kernels for intra and inter at qp 4, 8 and
   16), and times both versions of each kernel at the main path's shapes
   in turns (baseline, current, current, baseline; the encode kernels warm
   and L2-cold at N=32,400 and 131,072), with SDPA beside the attention
   and the achieved GB/s beside the byte bound of the others;
4. per seed, the bf16 prefill of full-width ``smollm-135m`` (B=8, S=512,
   random weights from the seed): the largest difference of the last
   position's logits from those of the plain-attention model, with the
   kernel, with the baseline's kernel, and with the plain emulations of the
   kernel's bf16 rounding (``attention_bf16_mma_ref``: P split into two
   bf16 parts, and P rounded to bf16 alone).  ``--seeds`` with no seed
   skips this part.

Imports neither JAX nor the reference package.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
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

dct_mod = importlib.import_module("repro_torch.kernels.dct.dct")
idct_mod = importlib.import_module("repro_torch.kernels.idct.idct")

DECODE_SHAPES = [(1, 1), (2, 3), (17, 5), (16, 33), (3, 65), (16, 777),
                 (16, 32768)]
ENCODE_N = [1, 2, 3, 5, 31, 33, 4099, 32400, 131072]
ENCODE_TIMED_N = [32400, 131072]


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
        elif "Used" in line or "spill" in line or "stack" in line:
            print("    " + line.split("ptxas info", 1)[-1].strip(" :"))


def baseline_libraries(tree: pathlib.Path) -> dict:
    kernels = tree / "src" / "repro_torch" / "kernels"
    libs = {
        "decode": kbuild.CudaLibrary(
            kernels / "decode" / "csrc" / dbuild.SOURCE.name, dbuild._bind),
        "flash": kbuild.CudaLibrary(
            kernels / "flash_attention" / "csrc" / fmod.SOURCE.name,
            fmod._bind),
        "dct": kbuild.CudaLibrary(
            kernels / "dct" / "csrc" / dct_mod.SOURCE.name, dct_mod._bind),
        "idct": kbuild.CudaLibrary(
            kernels / "idct" / "csrc" / idct_mod.SOURCE.name,
            idct_mod._bind)}
    for lib in libs.values():
        lib.build()
    return libs


def one_round_libraries() -> dict:
    """The encode kernels built with one round of 4 blocks per warp."""
    libs = {}
    for key, mod in (("dct", dct_mod), ("idct", idct_mod)):
        text = mod.SOURCE.read_text()
        cap = "if (cap > 0 && grid > cap) grid = cap;"
        cs.check(text.count(cap) == 1, f"{mod.SOURCE.name}: no {cap}")
        src = (ROOT / "build" / "probe" / f"{key}_one_round" / "csrc" /
               mod.SOURCE.name)
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text.replace(cap, ""))
        libs[key] = kbuild.CudaLibrary(src, mod._bind)
        libs[key].build()
    return libs


def library_patch(mod):
    """``patched(lib)``: a context that puts ``lib`` in place of ``mod``'s
    library (``None``: its own)."""
    def patched(lib):
        return mock.patch.object(mod, "LIBRARY", lib or mod.LIBRARY)
    return patched


def in_turns(name: str, fn, base, time_one, tag: str = "baseline") -> dict:
    """``time_one()`` under the other library (``base``, printed as
    ``tag``), the current one twice, then the other again; ``fn(lib)``
    patches a library in."""
    times = {tag: [], "current": []}
    for turn in (tag, "current", "current", tag):
        with fn(base if turn == tag else None):
            times[turn].append(time_one())
    print(f"{name}: " + "; ".join(
        f"{tag} {' / '.join(f'{t:.6f}' for t in ts)} ms"
        for tag, ts in times.items()), flush=True)
    return times


def decode_versions(base) -> None:
    patched = library_patch(dbuild)
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


def encode_versions(base: dict) -> None:
    """Old and new encode kernels: bit-identical outputs at ragged and full
    N, intra and inter, qp 4, 8 and 16."""
    dct_patch, idct_patch = library_patch(dct_mod), library_patch(idct_mod)
    rng = np.random.default_rng(2)
    for n in ENCODE_N:
        for qp in (4, 8, 16):
            for intra in (True, False):
                x = torch.from_numpy(cs.pixel_blocks(rng, n, not intra))
                x = x.cuda()
                q = dct_mod.dct_quant(x, qp, intra)
                y = idct_mod.idct_dequant(q, qp, intra)
                with dct_patch(base["dct"]), idct_patch(base["idct"]):
                    q_old = dct_mod.dct_quant(x, qp, intra)
                    y_old = idct_mod.idct_dequant(q, qp, intra)
                torch.cuda.synchronize()
                cs.check(torch.equal(q, q_old) and torch.equal(y, y_old),
                         f"encode N={n} qp={qp} intra={intra}: the two "
                         f"versions differ")
    print(f"dct_quant, idct_dequant: bit-identical to the baseline at N in "
          f"{ENCODE_N}, qp in (4, 8, 16), intra and inter", flush=True)


def launch_floor() -> None:
    """A 1-element ``add_`` timed as the encode kernels are: what each
    timing costs a kernel that does next to nothing."""
    tiny = torch.zeros(1, device="cuda")
    print(f"launch floor (1-element add_): warm "
          f"{cs.cuda_ms(lambda: tiny.add_(1), iters=50):.6f} ms, cold "
          f"{cs.cold_ms(lambda: tiny.add_(1), iters=50):.6f} ms", flush=True)


def rotating_ms(fn, args: list, iters: int = 48) -> float:
    """Mean device time of back-to-back ``fn(a)`` over ``args`` in turn,
    whose bytes together exceed the L2 cache: cold inputs, without the
    event pair around each launch that :func:`chip_smoke.cold_ms` needs."""
    for a in args:
        fn(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cs.SPIN_CYCLES)
    start.record()
    for k in range(iters):
        fn(args[k % len(args)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def encode_rotating() -> None:
    """The current encode kernels, back to back over rotating inputs of
    150 MB or more in all (inter, qp 8)."""
    rng = np.random.default_rng(4)
    for n in ENCODE_TIMED_N:
        copies = max(2, -(-150_000_000 // (n * cs.BYTES_PER_BLOCK)))
        xs = [torch.from_numpy(cs.pixel_blocks(rng, n, True)).cuda()
              for _ in range(copies)]
        qs = [dct_mod.dct_quant(x, cs.QP, False) for x in xs]
        b_ms, _ = cs.bound_ms(n, cs.BYTES_PER_BLOCK, cs.FLOPS_PER_BLOCK)
        for mod, args in ((dct_mod, xs), (idct_mod, qs)):
            fn = getattr(mod, mod.SOURCE.stem)
            t = rotating_ms(lambda a: fn(a, cs.QP, False), args)
            print(f"{mod.SOURCE.stem} N={n} inter, back to back over "
                  f"{copies} inputs: {t:.6f} ms, {b_ms / t:.3f} of the bound",
                  flush=True)


def encode_times(other: dict, tag: str) -> None:
    """Both encode kernels, current against ``other``'s libraries in turns,
    warm and L2-cold, at the timed N (inter, qp 8)."""
    rng = np.random.default_rng(3)
    for n in ENCODE_TIMED_N:
        x = torch.from_numpy(cs.pixel_blocks(rng, n, True)).cuda()
        q = dct_mod.dct_quant(x, cs.QP, False)
        b_ms, b_by = cs.bound_ms(n, cs.BYTES_PER_BLOCK, cs.FLOPS_PER_BLOCK)
        for key, mod, arg in (("dct", dct_mod, x), ("idct", idct_mod, q)):
            fn = getattr(mod, mod.SOURCE.stem)
            for kind, timer in (("warm", cs.cuda_ms), ("cold", cs.cold_ms)):
                times = in_turns(
                    f"{mod.SOURCE.stem} N={n} inter {kind} (bound "
                    f"{b_ms:.6f} ms, {b_by})", library_patch(mod), other[key],
                    lambda: timer(lambda: fn(arg, cs.QP, False), iters=50),
                    tag)
                for t_tag, ts in times.items():
                    t = min(ts)
                    print(f"  {t_tag}: {n * cs.BYTES_PER_BLOCK / t / 1e6:.1f}"
                          f" GB/s, {b_ms / t:.3f} of the bound", flush=True)


def flash_versions(base) -> None:
    patched = library_patch(fmod)
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
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
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
    for source in (fmod.SOURCE, dbuild.SOURCE, dct_mod.SOURCE,
                   idct_mod.SOURCE):
        ptxas_report(source)
    cs.build_all()
    launch_floor()
    encode_times(one_round_libraries(), "one round")
    encode_rotating()
    base = baseline_libraries(args.baseline) if args.baseline else None
    if base is not None:
        encode_versions(base)
        encode_times(base, "baseline")
        decode_versions(base["decode"])
        flash_versions(base["flash"])
    for seed in args.seeds:
        logits_margins(seed, base["flash"] if base else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
