#!/usr/bin/env python3
"""Card probe of the port's redesigned kernels: ``flash_attention`` and
``flash_attention_bwd`` (bf16 on tensor cores), ``decode_gop_blocks``,
``dct_quant`` and ``idct_dequant`` (warp-level), and ``sad_search`` (a
strip of candidates per thread).

    python3 scripts/torch_kernel_probe.py [--baseline DIR] [--seeds 0 1 2 3]
                                          [--ptxas-only | --sad-only |
                                           --bwd-only | --flash-only |
                                           --host-only]

From the root of a checkout, on a machine with a CUDA device and ``nvcc``:

1. prints the card's name and power limit, and what ``nvcc -Xptxas -v``
   says of every kernel of the six sources (registers, shared memory,
   stack frame, spills), each kernel by its demangled name and template
   arguments (the backward's bf16 kernels at D = 32, 64, 128 among them);
2. times a 1-element ``add_`` as the encode kernels are timed (what the
   warm and the L2-cold timing cost a kernel that does next to nothing);
   ``dct_quant`` and ``idct_dequant`` against a build of their sources with
   one round of 4 blocks per warp (the grid covering N, its cap taken
   out) in place of the capped grid whose warps loop over rounds, in
   turns, warm and L2-cold, at N=32,400 and 131,072; and both back to back
   over rotating inputs larger than the L2 cache; ``sad_search`` at both
   motion shapes against a build of its source with two strips of 9 dx
   per work item (at dx 0 and 8; ``kStripFixed`` 9 in place of 17), in
   turns, and through its generic path (inputs 4 bytes off 16-byte
   alignment); and where a build of its source with ``clock64`` counters
   spends each warp's cycles at both motion shapes (waiting for a group's
   copies and the block barrier; issuing the next group's copies and
   writing the last group's results; the searches; the argmin merge);
3. with ``--baseline DIR``, a tree holding another version's
   ``src/repro_torch/kernels/*/csrc/*.cu`` (for example ``git archive
   <commit> src/repro_torch/kernels | tar -x -C DIR``): builds those
   sources too, checks that both versions of ``decode_gop_blocks``,
   ``dct_quant``, ``idct_dequant``, ``sad_search`` and ``flash_attention``
   (over the smoke's shapes, bf16 and f32, causal and not, and with the
   current kernel also writing its row logsumexp; the baseline's entry
   must take the ``lse`` pointer too; one whose entry takes a single head
   width, from before v's width was a parameter, or a single length,
   from before the keys' length was one, is called through the current
   one, and so is a backward whose entry takes one length and one width)
   give bit-identical
   output at ragged and full shapes (the encode kernels for intra and
   inter at qp 4, 8 and 16; the search at both motion shapes, N in {1, 7,
   33, 500, 32400}, on float and integer pixels; ``flash_attention_bwd``
   at its old cases (Skv == S, Dv == Dqk) in f32 and bf16, at the smoke's
   shapes and ragged ones, D in {32, 64, 128}, G >= 1, causal and not,
   and the digests ``chip_smoke.BWD_OLD_DIGESTS`` records), and times both
   versions of each kernel at the main path's shapes
   in turns (baseline, current, current, baseline; the encode kernels warm
   and L2-cold at N=32,400 and 131,072), with SDPA beside the attention
   and the achieved GB/s beside the byte bound of the others (the search:
   its share of the operation bound and its GB/s; the backward: bf16 at
   the training shape and f32, each beside its operation bound);
4. per seed, the bf16 prefill of full-width ``smollm-135m`` (B=8, S=512,
   random weights from the seed): the largest difference of the last
   position's logits from those of the plain-attention model, with the
   kernel, with the baseline's kernel, and with the plain emulations of the
   kernel's bf16 rounding (``attention_bf16_mma_ref``: P split into two
   bf16 parts, and P rounded to bf16 alone).  ``--seeds`` with no seed
   skips this part.

5. the backward's bf16 rounding at (1, 9, 3, 2048, 64), causal and not:
   the plain emulation of the kernel's rounding before the final one (P
   and dS as hi + lo, and as bf16 alone) against the f32 plain gradient,
   and the kernel against the emulation, over each row's largest.

``--ptxas-only`` stops after the ptxas reports (about 40 s);
``--sad-only`` stops after the ptxas reports and ``sad_search``;
``--bwd-only`` prints the two attention sources' ptxas reports and runs
5 and the backward's part of 3 alone, then the backward's new cases at
the smoke's two timing shapes (MLA's (8, 16, 16, 512, 192 / 128) causal
and seamless' cross-attention, 512 queries over 128 keys): each dtype
per row against the plain chain, bf16 timed beside the plain version,
SDPA's backward and the bound, with the profiler's split by kernel
(about two minutes).  ``--flash-only``
prints the forward's ptxas report (and the baseline's), runs the
forward's part of 3 (the (D, D) pairs and the (192, 128) pair),
prints the sha256 digests of both groups' outputs that ``chip_smoke.py``
holds the kernel to (``chip_smoke.flash_digests``), from the current
kernel and from the baseline's, times the kernel at MLA's prefill shape
(8, 16, 16, 512, 192 / 128) beside the plain version and SDPA, and holds
it against the plain version with keys of another length than the
queries (``chip_smoke.FLASH_CROSS_SHAPES``, not causal), timed at
seamless-m4t-medium's cross-attention shape beside the plain version,
SDPA and the byte bound (about 2.5 minutes of command time).
``--host-only --baseline DIR`` times the serving call
``flash_attention_op`` of DIR's ``kernels/flash_attention/ops.py``
against this tree's host cost per call, in turns (about a minute).

Imports neither JAX nor the reference package.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
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
    attention_bf16_mma_ref, attention_bwd_bf16_mma_ref, attention_bwd_ref,
    attention_ref)
from repro_torch.kernels.sad import sad as sad_mod  # noqa: E402

dct_mod = importlib.import_module("repro_torch.kernels.dct.dct")
idct_mod = importlib.import_module("repro_torch.kernels.idct.idct")
bwd_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention_bwd")

DECODE_SHAPES = [(1, 1), (2, 3), (17, 5), (16, 33), (3, 65), (16, 777),
                 (16, 32768)]
ENCODE_N = [1, 2, 3, 5, 31, 33, 4099, 32400, 131072]
ENCODE_TIMED_N = [32400, 131072]
SAD_N = [1, 7, 33, 500, 32400]
SAD_STRIP = "constexpr int kStripFixed = 17;"
#: the backward's f32 shapes held to the baseline's bits: the smoke's, and
#: ragged S at each head dim
BWD_F32_SHAPES = [cs.BWD_F32, (1, 4, 2, 257, 32), (1, 6, 2, 100, 128),
                  (2, 3, 3, 1, 64), (1, 3, 1, 1500, 64)]
#: and the tensor-core path's: the training layout, G = 1 and ragged S at
#: each width (held in both dtypes, as the f32 shapes are)
BWD_BF16_SHAPES = [(1, 9, 3, 2048, 64), (2, 4, 4, 65, 32),
                   (1, 6, 2, 257, 128), (2, 2, 2, 100, 128)]


def ptxas_report(source: pathlib.Path, tag: str = "") -> None:
    out = ROOT / "build" / "probe" / f"{source.stem}{tag}_ptxas.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(out), str(source)],
                          capture_output=True, text=True, check=True)
    print(f"ptxas {source.name}{f' ({tag})' if tag else ''}:")
    filt = pathlib.Path(kbuild.nvcc()).with_name("cu++filt")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if filt.exists():  # "void (anonymous namespace)::f<(int)64>(..."
                name = subprocess.run([str(filt), name], capture_output=True,
                                      text=True).stdout.strip()
                name = name.split("::", 1)[-1].replace("(int)", "")
                name = name.split("(", 1)[0]
            print("  " + name)
        elif "Used" in line or "spill" in line or "stack" in line:
            print("    " + line.split("ptxas info", 1)[-1].strip(" :"))


def _bind_one_width(lib: ctypes.CDLL) -> None:
    """The forward's entry before v's width was a parameter: one head
    width ``d`` where the current entry takes ``dqk, dv``."""
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _bind_one_length(lib: ctypes.CDLL) -> None:
    """The forward's entry before the keys' length was a parameter: one
    length ``s`` where the current entry takes ``s, skv``."""
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


class OlderFlash:
    """A baseline forward library with an older entry (one head width,
    or one length), called through the current signature (``dqk != dv``
    or ``skv != s`` is refused, as the kernel would refuse an unknown
    width), so it can stand in for ``flash.LIBRARY``."""

    def __init__(self, source: pathlib.Path):
        self.one_width = "int dqk, int dv" not in source.read_text()
        self.lib = kbuild.CudaLibrary(
            source, _bind_one_width if self.one_width else _bind_one_length)

    def build(self):
        return self.lib.build()

    def load(self):
        raw, one_width = self.lib.load(), self.one_width

        class Entry:
            @staticmethod
            def flash_attention(q, k, v, o, lse, b, h, kvh, s, skv, dqk, dv,
                                dtype, causal, scale, stream):
                if skv != s or (one_width and dqk != dv):
                    return 1  # cudaErrorInvalidValue
                widths = (dqk,) if one_width else (dqk, dv)
                return raw.flash_attention(q, k, v, o, lse, b, h, kvh, s,
                                           *widths, dtype, causal, scale,
                                           stream)
        return Entry


def _bind_bwd_one_shape(lib: ctypes.CDLL) -> None:
    """The backward's entry before the widths and the keys' length were
    parameters: ``s, d`` where the current entry takes ``s, skv, dqk,
    dv``."""
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


class OlderBwd:
    """A baseline backward library with the older entry (one width, one
    length), called through the current signature (``dqk != dv`` or
    ``skv != s`` is refused, as the kernel would refuse an unknown
    width), so it can stand in for ``flash_attention_bwd.LIBRARY``."""

    def __init__(self, source: pathlib.Path):
        self.lib = kbuild.CudaLibrary(source, _bind_bwd_one_shape)

    def build(self):
        return self.lib.build()

    def load(self):
        raw = self.lib.load()

        class Entry:
            @staticmethod
            def flash_attention_bwd(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    b, h, kvh, s, skv, dqk, d_v, dtype,
                                    causal, scale, stream):
                if skv != s or dqk != d_v:
                    return 1  # cudaErrorInvalidValue
                return raw.flash_attention_bwd(q, k, v, o, dout, lse, delta,
                                               dq, dk, dv, b, h, kvh, s, dqk,
                                               dtype, causal, scale, stream)
        return Entry


def baseline_libraries(tree: pathlib.Path, only=None) -> dict:
    """The baseline's libraries (those named in ``only``, or all), built."""
    kernels = tree / "src" / "repro_torch" / "kernels"
    flash_src = kernels / "flash_attention" / "csrc" / fmod.SOURCE.name
    bwd_src = kernels / "flash_attention" / "csrc" / bwd_mod.SOURCE.name
    libs = {
        "decode": kbuild.CudaLibrary(
            kernels / "decode" / "csrc" / dbuild.SOURCE.name, dbuild._bind),
        "flash": (kbuild.CudaLibrary(flash_src, fmod._bind)
                  if "int s, int skv" in flash_src.read_text()
                  else OlderFlash(flash_src)),
        "dct": kbuild.CudaLibrary(
            kernels / "dct" / "csrc" / dct_mod.SOURCE.name, dct_mod._bind),
        "idct": kbuild.CudaLibrary(
            kernels / "idct" / "csrc" / idct_mod.SOURCE.name,
            idct_mod._bind),
        "sad": kbuild.CudaLibrary(
            kernels / "sad" / "csrc" / sad_mod.SOURCE.name, sad_mod._bind),
        "bwd": (kbuild.CudaLibrary(bwd_src, bwd_mod._bind)
                if "int s, int skv" in bwd_src.read_text()
                else OlderBwd(bwd_src))}
    libs = {k: lib for k, lib in libs.items() if only is None or k in only}
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


def two_strip_library() -> kbuild.CudaLibrary:
    """``sad_search`` built with two strips of 9 dx per dy on its
    fixed-shape path (7 current blocks of 34 items a thread block)."""
    text = sad_mod.SOURCE.read_text()
    cs.check(text.count(SAD_STRIP) == 1, f"{sad_mod.SOURCE.name}: no "
                                         f"{SAD_STRIP}")
    src = ROOT / "build" / "probe" / "sad_two_strips" / "csrc" / \
        sad_mod.SOURCE.name
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(SAD_STRIP, "constexpr int kStripFixed = 9;"))
    lib = kbuild.CudaLibrary(src, sad_mod._bind)
    lib.build()
    return lib


#: ``clock64`` counters around the phases of the kernel's group loop, and
#: an entry point that reads them: (anchor, text put after it)
SAD_PHASE_PROBES = [
    ("namespace {\n", "__device__ unsigned long long g_phase[5];\n"),
    ("  for (; grp < p.n_groups; grp += gridDim.x, ++i) {\n",
     "    const long long c0 = clock64();\n"),
    ("  int i = 0;\n",
     "  long long ph[4] = {0, 0, 0, 0};\n  const long long k0 = clock64();\n"),
    ("    __syncthreads();  // group grp staged; group grp - grid done with\n",
     "    const long long c1 = clock64();\n"),
    ("    unsigned long long key = kNone;\n",
     "    const long long c2 = clock64();\n"),
    ("    merge_key(key, gl, p.group, s_key[i & 1]);\n",
     "    const long long c4 = clock64();\n"),
]


def sad_phase_library() -> kbuild.CudaLibrary:
    """``sad_search`` with ``clock64`` counters: per warp, the cycles of
    each phase of its group loop, summed over the warps of a launch and
    read (then zeroed) by ``sad_phase_cycles``."""
    text = sad_mod.SOURCE.read_text()
    for anchor, add in SAD_PHASE_PROBES:
        cs.check(text.count(anchor) == 1, f"{sad_mod.SOURCE.name}: anchor "
                                          f"{anchor!r}")
        text = text.replace(anchor, anchor + add)
    # c3 before the merge: the searches end there
    merge = "    merge_key(key, gl, p.group, s_key[i & 1]);\n"
    text = text.replace(merge, "    const long long c3 = clock64();\n" + merge)
    end = "    const long long c4 = clock64();\n"
    text = text.replace(end, end + (
        "    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2;"
        " ph[3] += c4 - c3;\n"))
    last = "  if (i > 0) write_out(p, grp - gridDim.x, s_key[(i - 1) & 1]);\n}"
    cs.check(text.count(last) == 1, f"{sad_mod.SOURCE.name}: no kernel end")
    text = text.replace(last, last[:-1] + (
        "  if ((threadIdx.x & 31) == 0) {\n"
        "    for (int k = 0; k < 4; ++k) atomicAdd(&g_phase[k], "
        "(unsigned long long)ph[k]);\n"
        "    atomicAdd(&g_phase[4], (unsigned long long)(clock64() - k0));\n"
        "  }\n}"))
    text += ("\nextern \"C\" int sad_phase_cycles(void* host) {\n"
             "  unsigned long long zero[5] = {0, 0, 0, 0, 0};\n"
             "  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, "
             "sizeof(zero));\n"
             "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, "
             "sizeof(zero));\n"
             "  return (int)e;\n}\n")
    src = ROOT / "build" / "probe" / "sad_phases" / "csrc" / \
        sad_mod.SOURCE.name
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)

    def bind(lib):
        sad_mod._bind(lib)
        lib.sad_phase_cycles.argtypes = [ctypes.c_void_p]
        lib.sad_phase_cycles.restype = ctypes.c_int

    lib = kbuild.CudaLibrary(src, bind)
    lib.build()
    return lib


def sad_phases() -> None:
    """Shares of the warps' cycles in each phase of the group loop, one
    launch at each motion shape (the counters cost time themselves)."""
    lib = sad_phase_library()
    rng = np.random.default_rng(8)
    names = ("wait for copies and barrier", "issue copies, write results",
             "searches", "argmin merge")
    for h, w, b, r in cs.MOTION_PAIRS:
        n = (h // b) * (w // b)
        cur, win = cs._sad_inputs(rng, n, b, r, False)
        with library_patch(sad_mod)(lib):
            want = sad_mod.sad_search(cur, win)
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * 5)()
            cs.check(lib.load().sad_phase_cycles(cycles) == 0, "read")
            got = sad_mod.sad_search(cur, win)
            torch.cuda.synchronize()
            cs.check(lib.load().sad_phase_cycles(cycles) == 0, "read")
        cs.check(all(torch.equal(x, y) for x, y in zip(got, want)),
                 "the counters changed the results")
        total = cycles[4]
        print(f"sad_search N={n} b={b} r={r} phases (share of the warps' "
              f"cycles, clock64 build): " + "; ".join(
                  f"{name} {cycles[k] / total:.3f}"
                  for k, name in enumerate(names)), flush=True)


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


def sad_versions(base) -> None:
    """Old and new ``sad_search``: the same bits at both motion shapes and
    ragged N, on float and integer pixels."""
    patched = library_patch(sad_mod)
    rng = np.random.default_rng(5)
    for _, _, b, r in cs.MOTION_PAIRS:
        for n in SAD_N:
            for integer in (False, True):
                cur, win = cs._sad_inputs(rng, n, b, r, integer)
                new = sad_mod.sad_search(cur, win)
                with patched(base):
                    old = sad_mod.sad_search(cur, win)
                torch.cuda.synchronize()
                cs.check(all(torch.equal(x.view(torch.int32),
                                         y.view(torch.int32))
                             for x, y in zip(new, old)),
                         f"sad_search b={b} r={r} N={n} integer={integer}: "
                         f"the two versions differ")
    print(f"sad_search: bit-identical to the baseline at (b, r) in "
          f"{[m[2:] for m in cs.MOTION_PAIRS]}, N in {SAD_N}, float and "
          f"integer pixels", flush=True)


def sad_times(other, tag: str) -> None:
    """``sad_search`` against ``other``'s library in turns at both motion
    shapes, float pixels: device ms, share of the operation bound, GB/s."""
    rng = np.random.default_rng(6)
    for h, w, b, r in cs.MOTION_PAIRS:
        n = (h // b) * (w // b)
        cur, win = cs._sad_inputs(rng, n, b, r, False)
        b_ms, b_by = cs.sad_bound_ms(n, b, r)
        n_bytes = n * 4 * (b * b + (b + 2 * r) ** 2) + 12 * n
        times = in_turns(
            f"sad_search N={n} b={b} r={r} ({h}p pair; bound {b_ms:.6f} ms,"
            f" {b_by})", library_patch(sad_mod), other,
            lambda: cs.cuda_ms(lambda: sad_mod.sad_search(cur, win),
                               iters=50), tag)
        for t_tag, ts in times.items():
            t = min(ts)
            print(f"  {t_tag}: {b_ms / t:.3f} of the bound, "
                  f"{n_bytes / t / 1e6:.1f} GB/s", flush=True)


def sad_generic_path() -> None:
    """The current ``sad_search`` at both motion shapes on views 4 bytes
    off 16-byte alignment, which take its generic path."""
    rng = np.random.default_rng(7)
    for h, w, b, r in cs.MOTION_PAIRS:
        n = (h // b) * (w // b)
        cur, win = cs._sad_inputs(rng, n, b, r, False)
        views = []
        for x in (cur, win):
            flat = torch.empty(x.numel() + 1, device="cuda")
            views.append(flat[1:].view(x.shape))
            views[-1].copy_(x)
        cs.check(all(v.data_ptr() % 16 for v in views), "views aligned")
        same = all(torch.equal(x, y) for x, y in
                   zip(sad_mod.sad_search(*views),
                       sad_mod.sad_search(cur, win)))
        cs.check(same, f"sad_search b={b}: the generic path differs")
        b_ms, _ = cs.sad_bound_ms(n, b, r)
        t = cs.cuda_ms(lambda: sad_mod.sad_search(*views), iters=20)
        print(f"sad_search N={n} b={b} r={r} generic path (misaligned "
              f"views, same bits): {t:.6f} ms, {b_ms / t:.3f} of the bound",
              flush=True)


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
    # the serving call (no lse) gives the baseline's bits, and asking for
    # the lse changes no bit of o
    n = 0
    for shape in cs.FLASH_SHAPES + cs.FLASH_MLA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = cs._qkv(rng, *shape[:5], dtype,
                              dv=shape[5] if len(shape) > 5 else None)
            for causal in (True, False):
                cur = fmod.flash_attention(q, k, v, causal=causal)
                with_lse, _ = fmod.flash_attention(q, k, v, causal=causal,
                                                   return_lse=True)
                with patched(base):
                    old = fmod.flash_attention(q, k, v, causal=causal)
                cs.check(torch.equal(cur, old) and torch.equal(cur, with_lse),
                         f"flash_attention {shape} {dtype} causal={causal}: "
                         f"not the baseline's bits")
                n += 1
    print(f"flash_attention: {n} cases bit-identical to the baseline, with "
          f"and without lse", flush=True)
    with patched(base):
        old = cs.flash_digests(fmod.flash_attention)
    cur = cs.flash_digests(fmod.flash_attention)
    print(f"flash_attention (D, D) digests (chip_smoke.flash_digests): "
          f"baseline {old}; current {cur}; recorded in chip_smoke "
          f"{cs.FLASH_OLD_DIGESTS}", flush=True)
    cs.check(old == cur, "the digests differ from the baseline's")
    with patched(base):
        old = cs.flash_digests(fmod.flash_attention, cs.FLASH_MLA_SHAPES)
    cur = cs.flash_digests(fmod.flash_attention, cs.FLASH_MLA_SHAPES)
    print(f"flash_attention (192, 128) digests (chip_smoke.flash_digests "
          f"over FLASH_MLA_SHAPES): baseline {old}; current {cur}; recorded "
          f"in chip_smoke {cs.FLASH_MLA_OLD_DIGESTS}", flush=True)
    cs.check(old == cur, "the (192, 128) digests differ from the "
                         "baseline's")
    for shape in (cs.FLASH_MAIN, cs.FLASH_LONG, cs.FLASH_MOE,
                  cs.FLASH_HYBRID, cs.FLASH_VLM):
        q, k, v = cs._qkv(rng, *shape, torch.bfloat16)
        b_ms, b_by = cs.flash_bound_ms(shape, torch.bfloat16, True)
        in_turns(f"flash_attention {shape} bf16 causal (bound {b_ms:.6f} ms, "
                 f"{b_by})", patched, base,
                 lambda: cs.cuda_ms(lambda: fmod.flash_attention(q, k, v),
                                    iters=20))
        l_ms = cs.cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                       enable_gqa=True), iters=20)
        print(f"  sdpa: {l_ms:.6f} ms", flush=True)


def flash_mla() -> None:
    """The kernel at MLA's prefill shape, bf16 causal: against the plain
    version and SDPA (v narrower than q and k), and its error."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(5)
    shape = cs.FLASH_MLA
    q, k, v = cs._qkv(rng, *shape[:5], torch.bfloat16, dv=shape[5])
    got = fmod.flash_attention(q, k, v)
    err = float((got.float() - attention_ref(q, k, v).float()).abs().max())
    b_ms, b_by = cs.flash_bound_ms(shape, torch.bfloat16, True)
    times = [cs.cuda_ms(lambda: fmod.flash_attention(q, k, v), iters=20)
             for _ in range(3)]
    r_ms = cs.cuda_ms(lambda: attention_ref(q, k, v), iters=3, warmup=1)
    l_ms = cs.cuda_ms(lambda: sdpa(q, k, v, is_causal=True), iters=20)
    print(f"flash_attention {shape} bf16 causal: kernel "
          f"{' / '.join(f'{t:.6f}' for t in times)} ms, plain {r_ms:.6f} "
          f"ms, sdpa {l_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), max |diff| "
          f"from plain {err:.3g}", flush=True)


def flash_cross() -> None:
    """Keys of another length than the queries (not causal): the kernel
    against the plain version over the smoke's cases, f32 and bf16, the
    refusal of causal with two lengths, and the kernel, the plain version
    and SDPA timed at seamless-m4t-medium's cross-attention shape beside
    the byte bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(6)
    for shape in cs.FLASH_CROSS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = cs._qkv_cross(rng, shape, dtype)
            err = float((fmod.flash_attention(q, k, v, causal=False).float()
                         - attention_ref(q, k, v, causal=False).float())
                        .abs().max())
            print(f"flash_attention cross {shape} {dtype}: max |diff| from "
                  f"plain {err:.3g}", flush=True)
            cs.check(err <= cs.FLASH_TOL[dtype], f"cross {shape} {dtype}")
    try:
        fmod.flash_attention(q, k, v, causal=True)
        cs.check(False, "causal with two lengths was launched")
    except ValueError:
        pass
    shape = cs.FLASH_CROSS
    q, k, v = cs._qkv_cross(rng, shape, torch.bfloat16)
    b_ms, b_by = cs.cross_bound_ms(shape, torch.bfloat16)
    times = [cs.cuda_ms(lambda: fmod.flash_attention(q, k, v, causal=False),
                        iters=20) for _ in range(3)]
    r_ms = cs.cuda_ms(lambda: attention_ref(q, k, v, causal=False), iters=3,
                      warmup=1)
    l_ms = cs.cuda_ms(lambda: sdpa(q, k, v), iters=20)
    print(f"flash_attention cross {shape} bf16: kernel "
          f"{' / '.join(f'{t:.6f}' for t in times)} ms, plain {r_ms:.6f} "
          f"ms, sdpa {l_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})",
          flush=True)


def bwd_versions(base) -> None:
    """The backward's old cases (Skv == S, Dv == Dqk) bit-identical to the
    baseline's in both dtypes, causal and not, at D in {32, 64, 128}, G >=
    1 and ragged S; the digests ``chip_smoke.py`` holds them to, from
    both; then both versions in turns, bf16 at the training shape and
    f32."""
    patched = library_patch(bwd_mod)
    rng = np.random.default_rng(2)
    n = 0
    for shape in BWD_F32_SHAPES + BWD_BF16_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cs._qkv(rng, *shape, dtype)
            dout = cs._qkv(rng, *shape, dtype)[0]
            for causal in (True, False):
                o, lse = fmod.flash_attention(q, k, v, causal=causal,
                                              return_lse=True)
                cur = bwd_mod.flash_attention_bwd(q, k, v, o, dout, lse,
                                                  causal=causal)
                with patched(base):
                    old = bwd_mod.flash_attention_bwd(q, k, v, o, dout, lse,
                                                      causal=causal)
                cs.check(all(torch.equal(a, b) for a, b in zip(cur, old)),
                         f"flash_attention_bwd {shape} {dtype} causal="
                         f"{causal}: not the baseline's bits")
                n += 1
    print(f"flash_attention_bwd: {n} old cases (Skv == S, Dv == Dqk) "
          f"bit-identical to the baseline, f32 and bf16", flush=True)
    with patched(base):
        old = cs.bwd_digests(bwd_mod.flash_attention_bwd)
    cur = cs.bwd_digests(bwd_mod.flash_attention_bwd)
    print(f"flash_attention_bwd old-case digests (chip_smoke.bwd_digests): "
          f"baseline {old}; current {cur}; recorded in chip_smoke "
          f"{cs.BWD_OLD_DIGESTS}", flush=True)
    cs.check(old == cur, "the backward's digests differ from the "
                         "baseline's")
    for shape, dtype in ((cs.BWD_MAIN, torch.bfloat16),
                         (cs.BWD_F32, torch.float32)):
        q, k, v = cs._qkv(rng, *shape, dtype)
        dout = cs._qkv(rng, *shape, dtype)[0]
        o, lse = fmod.flash_attention(q, k, v, return_lse=True)
        b_ms, b_by = cs.flash_bwd_bound_ms(shape, dtype, True)
        in_turns(f"flash_attention_bwd {shape} {dtype} causal (bound "
                 f"{b_ms:.6f} ms, {b_by})", patched, base,
                 lambda: cs.cuda_ms(lambda: bwd_mod.flash_attention_bwd(
                     q, k, v, o, dout, lse), iters=5))
        bwd_kernel_split(f"flash_attention_bwd {shape} {dtype} causal",
                         lambda: bwd_mod.flash_attention_bwd(
                             q, k, v, o, dout, lse))


def bwd_new_cases() -> None:
    """The backward at MLA's widths and over keys of another length, at
    the smoke's two timing shapes (``chip_smoke.BWD_MLA``, causal, and
    ``chip_smoke.BWD_CROSS``, not causal): each dtype held per row against
    the plain chain, then bf16 timed beside the plain version, SDPA's
    backward and the bound, with the profiler's split by kernel."""
    rng = np.random.default_rng(7)
    for shape, causal in ((cs.BWD_MLA, True), (cs.BWD_CROSS, False)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = cs._qkv_bwd(rng, shape, dtype)
            dout = cs._dout_bwd(rng, q, v)
            errs = cs.bwd_chain_errs(q, k, v, dout, causal)
            print(f"flash_attention_bwd {shape} {dtype} causal={causal} vs "
                  f"plain: " + ", ".join(f"{n} {e:.3g}"
                                         for n, e in errs.items()),
                  flush=True)
        q, k, v = cs._qkv_bwd(rng, shape, torch.bfloat16)
        dout = cs._dout_bwd(rng, q, v)
        o, lse = fmod.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
        row = cs.bwd_times(q, k, v, o, dout, lse, causal, shape)
        print(f"flash_attention_bwd {shape} bf16 causal={causal}: " +
              " ".join(f"{n}={x}" for n, x in row.items()), flush=True)
        bwd_kernel_split(f"flash_attention_bwd {shape} bf16",
                         lambda: bwd_mod.flash_attention_bwd(
                             q, k, v, o, dout, lse, causal=causal))


def bwd_rounding(shape=(1, 9, 3, 2048, 64)) -> None:
    """The backward's bf16 design in numbers: the plain emulation of its
    rounding (``attention_bwd_bf16_mma_ref``) before the final rounding,
    P and dS split into hi + lo and as bf16 alone, against the f32 plain
    gradient, from f32 copies of bf16 inputs; then the kernel against the
    emulation with the split.  Each as the smoke reads it: the largest
    error over the row's largest |gradient|."""
    rng = np.random.default_rng(4)
    for causal in (True, False):
        q, k, v = cs._qkv(rng, *shape, torch.bfloat16)
        dout = cs._qkv(rng, *shape, torch.bfloat16)[0]
        o, lse = fmod.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
        f32 = [x.float() for x in (q, k, v, o, dout)]
        exact = attention_bwd_ref(*f32, lse, causal=causal)
        floor = cs.BWD_FLOOR * max(float(w.abs().max()) for w in exact)
        errs = {}
        for name, split in (("hi + lo", True), ("bf16 alone", False)):
            got = attention_bwd_bf16_mma_ref(*f32, lse, causal=causal,
                                             split=split)
            errs[name] = [cs.bwd_row_err(a, w, floor)
                          for a, w in zip(got, exact)]
        design = attention_bwd_bf16_mma_ref(q, k, v, o, dout, lse,
                                            causal=causal)
        kernel = bwd_mod.flash_attention_bwd(q, k, v, o, dout, lse,
                                             causal=causal)
        floor = cs.BWD_FLOOR * max(float(w.float().abs().max())
                                   for w in design)
        errs["kernel vs hi + lo, rounded"] = [
            cs.bwd_row_err(a, w, floor) for a, w in zip(kernel, design)]
        print(f"flash_attention_bwd rounding {shape} causal={causal}, "
              f"dq / dk / dv over the row's largest: " + "; ".join(
                  f"{n} " + " / ".join(f"{e:.3g}" for e in es)
                  for n, es in errs.items()), flush=True)


def bwd_kernel_split(what: str, fn, calls: int = 5) -> None:
    """Device ms per call of each of the backward's three kernels, from the
    profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {"delta": 0.0, "dkdv": 0.0, "dq": 0.0}
    for evt in prof.key_averages():
        name = evt.key
        if evt.device_type == DeviceType.CUDA and "attention_bwd" in name:
            part = next(p for p in split if f"bwd_{p}_" in name)
            split[part] += evt.device_time_total / 1e3 / calls
    print(f"{what}, device ms per call by kernel (torch.profiler): " +
          " ".join(f"{k}={v:.6f}" for k, v in split.items()), flush=True)


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


def op_host_costs(baseline: pathlib.Path) -> None:
    """The serving call's host cost: ``flash_attention_op`` (no grad, as
    serving calls it) of the baseline tree's
    ``kernels/flash_attention/ops.py`` (loaded by path; its imports are
    this tree's wrappers) against this tree's, at a launch-bound shape and
    at smollm-135m's prefill, each run of 2,000 calls in turns (baseline,
    current, current, baseline, twice), after checking that both give the
    same output."""
    spec = importlib.util.spec_from_file_location(
        "baseline_flash_ops", baseline / "src" / "repro_torch" / "kernels" /
        "flash_attention" / "ops.py")
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    from repro_torch.kernels.flash_attention import ops

    fmod.LIBRARY.build()
    for b, h, kv, s, d in ((1, 9, 3, 16, 64), cs.FLASH_MAIN):
        q, k, v = cs._qkv(np.random.default_rng(s), b, h, kv, s, d,
                          torch.bfloat16)
        runs = {"baseline": [], "current": []}
        with torch.no_grad():
            cs.check(torch.equal(base.flash_attention_op(q, k, v),
                                 ops.flash_attention_op(q, k, v)),
                     "flash_attention_op: the two trees differ")
            for turn in ("baseline", "current", "current", "baseline") * 2:
                op = (base if turn == "baseline" else ops).flash_attention_op
                runs[turn].append(cs.host_us(lambda: op(q, k, v), 2000))
        print(f"flash_attention_op host us/call at {(b, h, kv, s, d)} bf16, "
              f"no grad, in turns: " + "; ".join(
                  f"{name} {sorted(round(x, 3) for x in xs)}"
                  for name, xs in runs.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--ptxas-only", action="store_true",
                      help="stop after the ptxas reports")
    only.add_argument("--sad-only", action="store_true",
                      help="stop after the ptxas reports and sad_search")
    only.add_argument("--bwd-only", action="store_true",
                      help="the attention sources' ptxas reports and the "
                           "backward's versions alone")
    only.add_argument("--flash-only", action="store_true",
                      help="the forward's ptxas reports, versions, digests "
                           "and MLA shape alone")
    only.add_argument("--host-only", action="store_true",
                      help="with --baseline: flash_attention_op's host cost "
                           "against the baseline's, alone")
    args = ap.parse_args()
    if args.host_only and not args.baseline:
        ap.error("--host-only needs --baseline")
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
    if args.host_only:
        op_host_costs(args.baseline)
        return 0
    if args.bwd_only:
        for source in (fmod.SOURCE, bwd_mod.SOURCE):
            ptxas_report(source)
        bwd_rounding()
        if args.baseline:
            bwd_versions(baseline_libraries(args.baseline, ("bwd",))["bwd"])
        bwd_new_cases()
        return 0
    if args.flash_only:
        ptxas_report(fmod.SOURCE)
        base = None
        if args.baseline:
            src = (args.baseline / "src" / "repro_torch" / "kernels" /
                   "flash_attention" / "csrc" / fmod.SOURCE.name)
            ptxas_report(src, tag="baseline")
            base = baseline_libraries(args.baseline, ("flash",))["flash"]
        fmod.LIBRARY.build()
        if base is not None:
            flash_versions(base)
        flash_mla()
        flash_cross()
        return 0
    for source in (fmod.SOURCE, bwd_mod.SOURCE, dbuild.SOURCE,
                   dct_mod.SOURCE, idct_mod.SOURCE, sad_mod.SOURCE):
        ptxas_report(source)
    if args.ptxas_only:
        return 0
    cs.build_all()
    base = baseline_libraries(args.baseline) if args.baseline else None
    if base is not None:
        sad_versions(base["sad"])
        sad_times(base["sad"], "baseline")
    sad_times(two_strip_library(), "two strips")
    sad_generic_path()
    sad_phases()
    if args.sad_only:
        return 0
    launch_floor()
    encode_times(one_round_libraries(), "one round")
    encode_rotating()
    if base is not None:
        encode_versions(base)
        encode_times(base, "baseline")
        decode_versions(base["decode"])
        flash_versions(base["flash"])
        bwd_versions(base["bwd"])
    for seed in args.seeds:
        logits_margins(seed, base["flash"] if base else None)
    bwd_rounding()
    return 0


if __name__ == "__main__":
    sys.exit(main())
