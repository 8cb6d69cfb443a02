#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

From the root of a checkout, on a machine with a CUDA device and ``nvcc``:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the six CUDA kernels from their ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints ``build_s``;
3. decode kernel phase: holds ``decode_gop_blocks`` against its plain
   PyTorch version on the card for F in {1, 4, 16}, M in {64, 4096,
   32768}, qp in {4, 8, 12} (max |diff| <= 1e-3 on pixel-scale output) and
   times both, with the bound F*M*384 B over the card's published HBM rate
   and the kernel's achieved GB/s beside its share of the bound;
4. encode kernel phase: holds ``dct_quant`` and ``idct_dequant`` against
   their plain versions, bit for bit, for N in {64, 4096, 32400, 131072},
   qp in {4, 8, 16}, intra and inter, on pixel-scale blocks and residuals
   from the seed; times both at qp 8, warm (back-to-back launches on the
   same input, as the ingest finds its input in L2) and L2-cold (a 64 MB
   write and a 64 MB read before each launch), against the bound N*384 B
   (``share_of_bound`` from the cold time), and each wrapper's host cost
   per call;
5. attention kernel phase: holds ``flash_attention`` against its plain
   version (atol 2e-5 in f32, 2e-2 in bf16) for (B, H, KV, S, D) in
   {(2,4,4,128,32), (2,4,2,256,64), (2,8,1,256,32), (8,9,3,512,64),
   (1,9,3,4096,64), (3,9,3,100,64), (1,9,3,1,64)}, causal and not, bf16
   and f32, on ``randn`` inputs from the seed; times it, the plain version
   and ``scaled_dot_product_attention`` (the library yardstick, which the
   port never calls) in bf16 at the prefill shape (8,9,3,512,64) and at
   (1,9,3,4096,64), with the byte and operation bounds, and the wrapper's
   host cost per call;
6. sad kernel phase: holds ``sad_search`` against its plain version for
   (b, r) in {(8, 4), (16, 8), (8, 8), (4, 0), (8, 1), (8, 5), (16, 3),
   (5, 2)} (the motion shapes (8, 8) and (16, 8) take the kernel's
   fixed-shape path, the others its generic path, and r in {1, 3, 5}
   leaves a short strip) and N in {1, 7, 64, 500, 32400}: on integer
   pixels in [0, 255] (with a constant window) all
   three outputs equal, ties included; on ``randn * 25`` pixels ``sad``
   within rtol 1e-5 and ``dy``/``dx`` equal except at near-ties (counted);
   times it, the plain version and the wrapper's host cost at both motion
   path shapes against the bound (no single PyTorch call computes it);
7. motion path: frames 0 and 1 of the 1080p video (b=8, r=8: 32,400
   blocks) and a 720p pair (b=16, r=8: 3,600 blocks), each through
   ``frame_motion_blocks``, one pinned H2D copy, one ``sad_search_op``
   launch and one D2H copy, with host times; held against the plain
   version (exact on the frames rounded to 8 bits); then a 1080p frame
   rolled by (3, -2), whose inner blocks must match at (r-3, r+2) with SAD 0;
8. ingest phase: ``VideoStore.ingest`` of a 1080p, 64-frame synthetic video
   (gop 16, qp 8) under a 6x8 uniform layout (48 tiles; a frame is one
   32,400-block launch) encodes on the card; the encode launch counters
   must grow; SOT 0's stored coefficients are held against the numpy
   ``encode_tile`` (equal share >= 0.999, PSNR within 0.1 dB), and so are
   the other SOTs', both encode wall times printed, and one SOT's encode
   split by device time
   (``torch.profiler``: the two kernels, the other kernels' share, the
   copies) and the host time of the size model;
9. scan phase: a full-frame scan, a label (ROI) scan, ``execute_many`` of
   four overlapping scans and a ``serve()`` session of four requests on the
   ingested store; every region is held against the numpy ``decode_tile``
   oracle at atol=1e-3, rtol=1e-5, merged and served results must equal the
   serial ones bit for bit, and the decode launch counter must grow;
10. video server phase: the same store (tuning off, cache off) served
   in-process by ``VideoStoreServer`` on a Unix socket to 4 client threads,
   each with its own ``RemoteVideoStore`` sending 8 scans (full frames 0-16,
   ``car`` scans), once over the socket transport, where shared memory
   exists once over shm, and where msgpack is the default once more over
   the socket with JSON; every reply bit-identical to the in-process scan
   (which is held against the oracle), the decode launch counter growing;
   p50/p95 latency, requests/s, reply bytes and the wire codec printed;
   then ``python -m repro_torch.tasm_serve --device cuda`` as a subprocess
   over a small store root answers ``ping``, ``config()`` (a cuda decode)
   and one scan, and exits 0 on ``shutdown_server()``;
11. cluster phase: three ``python -m repro_torch.tasm_serve --device
   cuda`` node processes (disk-backed, tuning and cache off) behind one
   ``python -m repro_torch.tasm_router --replication 2`` process (first
   checks that /dev/shm has twice the five servers' shm pools free);
   three 1080p, 32-frame cameras ingested through a ``ClusterClient``
   under the 6x8 layout, each onto 2 nodes; an in-process store on the
   card from the same frames and its numpy oracle; 4 client threads x 8
   routed scans (``car`` 0-32 of each camera, ``person`` 8-24, full frames
   0-16 of cam1), then the same requests straight to each camera's
   primary, p50/p95 and requests/s of both, with the card's
   ``utilization.gpu`` sampled through the ingest and the waves; a second
   routed wave during
   which cam0's primary is SIGKILLed (no read fails, ``node_health``
   reports it down, ``nvidia-smi`` drops its context within 30 s); a
   routed retile of cam0 SOT 0 to 2x2; a fresh node ``d`` joined and the
   lost node repaired through the router's CLI (``--join-node``,
   ``--repair node=... --wait 300``, both exit 0), each copy read straight
   from its new replica at the router's epochs; every live node's decode
   device ``cuda`` (through the router's ``config()``) and its pid holding
   a context in ``nvidia-smi``, the router's holding none; SIGTERM of the
   router and nodes (exit 0, sockets gone) and no shared-memory segment
   left behind.  Every reply is bit-identical to the in-process store and
   within atol=1e-3, rtol=1e-5 of the oracle;
12. retile phase, twice (inline tuning, then the background tuner with
   ``drain_tuner``): ``RegretPolicy`` with ``CostModel(beta=1.4e-8,
   gamma=1e-5)`` over repeated ``car`` scans of frames 0-32 of the same
   1080p video until a SOT's epoch rises; the encode launch counters must
   grow, and every region of a scan after the retile is held against the
   numpy oracle of the new tiles;
13. calibration: ``calibrated_cost_model`` on the card at its small default
   sizes (10 timed repeats of each decode sample), with finite positive
   beta and encode_per_pixel and a finite, non-negative gamma;
14. serve phase, ``smollm-135m`` at full width (30 layers, d_model 576,
   ``make_serve_config(cfg, 1)``, bf16 weights from the seed) on the card:
   (a) ``greedy_generate`` of 8 prompts of 512 tokens, 64 new tokens; the
   prefill launches ``flash_attention`` 30 times; TTFT of the prefill and
   steady decode tokens/s; (b) the same with the prefill attention
   switched to the plain version (a test-only patch of the attention
   module): last-position prefill logits within 5e-2, greedy-token
   agreement printed; (c) the same in f32 at 4 layers: logits within 1e-3,
   greedy agreement >= 0.99; (d) ``ContinuousBatcher(slots=8,
   max_len=640)`` over 16 requests of 64-512 prompt tokens and 16-64 new
   tokens: every request finishes, 30 launches per wave, stats printed;
   (e) the device time of one prefill and of one decode step, split by
   ``torch.profiler`` into ``flash_attention``, matmuls and the rest, and
   the device's busy share of their wall time;
15. attention backward kernel phase: holds ``flash_attention_bwd`` (dq,
   dk, dv from the forward's o and row logsumexp) against its plain
   version, relative to the largest |gradient| (1e-4 in f32, 8e-3 in
   bf16), at the training shape (8, 9, 3, 2048, 64) bf16 causal and at
   (2, 9, 3, 512, 64) f32, causal and not; times it, the plain version and
   the backward of ``scaled_dot_product_attention`` (``enable_gqa``; the
   library yardstick, which the port never calls) against the operation
   bound (five causal-halved S^2 D products over the card's peak for the
   type);
16. train phase, ``smollm-135m`` at its published width (30 layers,
   d_model 576, vocab 49,152), bf16 params with an f32 master copy, remat
   on: (a) ``TRAIN_STEPS`` steps of ``make_train_step`` at B=8, S=2048 on
   the structured synthetic stream, with the counts set to 0 just before
   and read just after: per step 60 ``flash_attention`` launches (the
   checkpointed forward runs twice) and 30 ``flash_attention_bwd``; the
   median step time, tokens/s, peak memory, every loss finite, the mean
   of the last 5 losses below the first; (b) one step's device time by
   ``torch.profiler`` (forward and backward attention, matmuls, the rest)
   and the busy share of its wall time; (c) an f32 step at 2 layers, full
   width, B=2, S=256 on the card and on the CPU from the same weights:
   loss within rtol 1e-5, every gradient within 1e-4 of its leaf's
   largest, and the params after the AdamW update from the same gradients
   within 1e-6 of their leaf's largest; (d) ``recoverable_train_loop``
   with checkpoints every 2 steps and a simulated fault at step 3,
   restored from the step-2 checkpoint bit for bit (``restarts == 1``);
   (e) ``python -m repro_torch.launch.train --device cuda`` for 3 steps
   with ``--checkpoint-dir``, then ``--resume`` to 5;
17. prints the times of the kernels redesigned for this card (all five:
   ``sad_search`` at both motion shapes) beside the times recorded before
   the redesign (``BEFORE_REDESIGN``, from PERF.md),
   one JSON line with the kernels' numbers, then as its last line
   ``{"ok": true, "device": {...}}``.

f32 products on the card stay f32 (``allow_tf32`` is set False for
matmuls and cuDNN) in every comparison.

Every path is driven with the launch counters set to 0 just before it and
read just after.  Any failed check raises, and the script exits non-zero
without the last line; so it does without a CUDA device, or outside a
checkout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: fp32 adds the card issues per second: half the FLOP/s peak, which counts
#: an FMA as two operations
FP32_ADDS = FP32_FLOPS / 2
#: per 8x8 block-frame of the decode: int16 in + f32 out; 64 pixels x
#: (16 FMAs + dequant multiply + running-sum add)
BYTES_PER_BLOCK_FRAME = 64 * 2 + 64 * 4
FLOPS_PER_BLOCK_FRAME = 64 * (2 * 16 + 2)
#: per 8x8 block of dct_quant / idct_dequant: f32 and int16 once each; 64
#: coefficients x (two 8-point products of 8 multiplies and 7 adds, plus
#: the divide or the dequant multiply)
BYTES_PER_BLOCK = 64 * 4 + 64 * 2
FLOPS_PER_BLOCK = 64 * (2 * 15 + 1)
#: bf16 dense tensor-core peak of the H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12
#: tolerances of the attention kernel against its plain version (the
#: reference's, tests/test_kernels.py), and of the serve comparisons
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGITS_ATOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
AGREE_F32 = 0.99
#: GPU cycles the timing spin holds the stream for (~30 ms at 1.98 GHz):
#: longer than the host takes to enqueue 50 launches of any wrapper here
SPIN_CYCLES = 60_000_000
#: bytes written, then read from a second buffer, before each launch of an
#: L2-cold timing: past the card's 50 MB L2, so a launch finds neither its
#: input nor its output there, and the lines it evicts are clean
FLUSH_BYTES = 64 << 20
ATOL, RTOL = 1e-3, 1e-5
SHARE = 0.999
PSNR_DB = 0.1

#: the main path's configuration
DEVICE = "cuda"
H, W, N_FRAMES = 1080, 1920, 64
GOP, QP = 16, 8
LAYOUT = (6, 8)
RETILE_FRAMES = 32
#: the serve path's configuration
ARCH = "smollm-135m"
#: the train path: B x S at SmolLM-135M's context length, steps, the
#: backward kernel's training shape and an f32 shape, and the f32
#: card-against-CPU step (layers, B, S)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 20
BWD_MAIN = (8, 9, 3, 2048, 64)
BWD_F32 = (2, 9, 3, 512, 64)
#: the backward kernel (fed the forward kernel's o and lse) against the
#: plain gradient from the plain o and lse, each element over its row's
#: largest |gradient| (at least 1e-2 of the largest of the call, since
#: dq's causal row 0 and dq, dk at S = 1 are 0 up to rounding): bf16 one
#: ulp of the row's largest (2^-7) and some f32 noise, f32 sums in another
#: order; the phase prints its readings
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
BWD_FLOOR = 1e-2
#: the row logsumexp against the plain one: about ten f32 ulps at the
#: |lse| ~ 10 of these shapes
LSE_ATOL = 1e-5
TRAIN_F32 = (2, 2, 256)
GRAD_RTOL = 1e-4
SERVE_B, SERVE_S, SERVE_NEW = 8, 512, 64
F32_LAYERS = 4
FLASH_SHAPES = [(2, 4, 4, 128, 32), (2, 4, 2, 256, 64), (2, 8, 1, 256, 32),
                (8, 9, 3, 512, 64), (1, 9, 3, 4096, 64), (3, 9, 3, 100, 64),
                (1, 9, 3, 1, 64)]
BATCH_SLOTS, BATCH_MAX_LEN, BATCH_REQUESTS = 8, 640, 16
BATCH_PROMPT, BATCH_NEW = (64, 512), (16, 64)
FLASH_MAIN = (8, 9, 3, 512, 64)
FLASH_LONG = (1, 9, 3, 4096, 64)
#: the motion search: the sweep of the sad kernel phase, and the two frame
#: pairs of the motion path, (height, width, b, r); the first is the main
#: path's shape (1080 is not a multiple of 16, so it takes b=8)
SAD_SWEEP_BR = [(8, 4), (16, 8), (8, 8), (4, 0), (8, 1), (8, 5), (16, 3),
                (5, 2)]
SAD_SWEEP_N = [1, 7, 64, 500, 32400]
SAD_TOL = 1e-5
MOTION_PAIRS = [(H, W, 8, 8), (720, 1280, 16, 8)]
PLANT = (3, -2)
#: the video server phase: client threads, requests per client, queries
SERVER_CLIENTS, SERVER_REQUESTS = 4, 8
SERVER_QUERIES = [("frame", (0, 16)), ("car", (0, 64)), ("car", (16, 48))]
CLI_SPEC = (192, 320, 32)
#: the cluster phase: 1080p cameras of CLUSTER_FRAMES frames each (a
#: 265 MB f32 ingest, just under the default 256 MiB frame cap, so nodes,
#: router and clients take CLUSTER_FRAME_MB), and the retile's layout
CLUSTER_CAMS, CLUSTER_FRAMES, CLUSTER_FRAME_MB = 3, 32, 1024
CLUSTER_RETILE = (2, 2)

#: device ms of the redesigned kernels before their redesign, at the main
#: path's shapes (PERF.md section 6: chip_smoke.py on an NVIDIA H100 80GB
#: HBM3 at 700.00 W, with the first version of each kernel), printed
#: beside this run's
BEFORE_REDESIGN = {
    "decode_gop_blocks F=16 M=32768": 0.158934,
    f"flash_attention {FLASH_MAIN} bf16 causal": 0.221118,
    f"flash_attention {FLASH_LONG} bf16 causal": 1.557814,
    f"dct_quant N={H * W // 64} inter": 0.025238,
    f"idct_dequant N={H * W // 64} inter": 0.025610,
    "sad_search N=32400 b=8 r=8": 0.223352,
    "sad_search N=3600 b=16 r=8": 0.092842,
}

KERNELS = {
    "decode_gop_blocks": dict(
        source="src/repro_torch/kernels/decode/csrc/decode_gop_blocks.cu",
        replaces="src/repro/kernels/decode/decode.py:46"),
    "dct_quant": dict(
        source="src/repro_torch/kernels/dct/csrc/dct_quant.cu",
        replaces="src/repro/kernels/dct/dct.py:32"),
    "idct_dequant": dict(
        source="src/repro_torch/kernels/idct/csrc/idct_dequant.cu",
        replaces="src/repro/kernels/idct/idct.py:30"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:63"),
    "sad_search": dict(
        source="src/repro_torch/kernels/sad/csrc/sad_search.cu",
        replaces="src/repro/kernels/sad/sad.py:41"),
    # no Pallas kernel: the gradient the reference takes by autodiff of
    # its chunked jnp attention
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:87"),
}


def counters() -> dict:
    from repro_torch.kernels import dct, decode, flash_attention, idct, sad

    return {"decode_gop_blocks": decode.LAUNCHES, "dct_quant": dct.LAUNCHES,
            "idct_dequant": idct.LAUNCHES,
            "flash_attention": flash_attention.LAUNCHES,
            "sad_search": sad.LAUNCHES,
            "flash_attention_bwd": flash_attention.BWD_LAUNCHES}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {name: c.count for name, c in counters().items()}


def bound_ms(n: int, bytes_per: int, flops_per: int) -> tuple[float, str]:
    t_bytes = n * bytes_per / HBM_BYTES_PER_S
    t_ops = n * flops_per / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs.  A
    spin kernel holds the stream while the host enqueues every run, so the
    events time the device's work, not the wrappers' host cost between
    launches (that is :func:`host_us`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` with the L2 cache evicted before each run
    (``FLUSH_BYTES`` written, then as many read from another buffer), each
    run timed by its own pair of events while a spin kernel holds the
    stream, as in :func:`cuda_ms`."""
    dirty = torch.empty(FLUSH_BYTES // 4, device=DEVICE)
    clean = torch.ones(FLUSH_BYTES // 4, device=DEVICE)
    sink = torch.empty((), device=DEVICE)

    def flush():
        dirty.fill_(1.0)
        torch.sum(clean, dim=0, out=sink)

    # first calls load their kernels, which would stall the enqueue below
    flush()
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call of ``fn`` while the device keeps up: the
    wrapper's own cost (checks, allocation, ``ctypes`` call, launch)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def random_stream(rng, n_frames: int, m: int, qp: int) -> np.ndarray:
    """Coefficients with the statistics of encoded video: a keyframe row
    whose DC lands in [0, 255] pixels plus small AC terms, then sparse
    small residuals."""
    q = np.zeros((n_frames, m, 8, 8), dtype=np.int16)
    dc_max = int(255 * 8 / (16 * max(qp, 1) / 16.0))
    q[0, :, 0, 0] = rng.integers(0, dc_max + 1, size=m)
    q[0] += rng.integers(-3, 4, size=(m, 8, 8)).astype(np.int16)
    if n_frames > 1:
        resid = rng.integers(-2, 3, size=(n_frames - 1, m, 8, 8))
        resid[rng.random(resid.shape) < 0.7] = 0
        q[1:] = resid
    return q


def pixel_blocks(rng, n: int, residual: bool) -> np.ndarray:
    """Pixel-scale blocks in [0, 255] (keyframes) or residuals (centred,
    with the spread of P-frame differences)."""
    if residual:
        return (rng.standard_normal((n, 8, 8)) * 12).astype(np.float32)
    return (rng.random((n, 8, 8)) * 255).astype(np.float32)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def build_all() -> float:
    """Build the six kernels, one ``nvcc`` per source, all at once."""
    from repro_torch.kernels.dct import LIBRARY as DCT
    from repro_torch.kernels.decode.build import LIBRARY as DECODE
    from repro_torch.kernels.flash_attention import BWD_LIBRARY as BWD
    from repro_torch.kernels.flash_attention import LIBRARY as FLASH
    from repro_torch.kernels.idct import LIBRARY as IDCT
    from repro_torch.kernels.sad import LIBRARY as SAD

    libs = (FLASH, BWD, DECODE, DCT, IDCT, SAD)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))
    return time.perf_counter() - t0


# ------------------------------------------------------------ kernel phases
def decode_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.decode import decode_fused_ref, decode_gop_blocks

    rng = np.random.default_rng(seed)
    worst = 0.0
    at_main = None
    for n_frames in (1, 4, 16):
        for m in (64, 4096, 32768):
            for qp in (4, 8, 12):
                q = torch.from_numpy(random_stream(rng, n_frames, m, qp))
                q = q.to(DEVICE)
                got = decode_gop_blocks(q, qp)
                want = decode_fused_ref(q, qp)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(err <= ATOL, f"kernel vs plain F={n_frames} M={m} "
                                   f"qp={qp}: max |diff| {err} > {ATOL}")
                worst = max(worst, err)
                if qp != 8:
                    continue
                k_ms = cuda_ms(lambda: decode_gop_blocks(q, qp), iters=50)
                r_ms = cuda_ms(lambda: decode_fused_ref(q, qp), iters=3,
                               warmup=1)
                b_ms, b_by = bound_ms(n_frames * m, BYTES_PER_BLOCK_FRAME,
                                      FLOPS_PER_BLOCK_FRAME)
                gb_s = n_frames * m * BYTES_PER_BLOCK_FRAME / k_ms / 1e6
                print(f"decode F={n_frames:2d} M={m:5d} qp={qp}: "
                      f"kernel_ms={k_ms:.6f} ref_ms={r_ms:.6f} "
                      f"bound_ms={b_ms:.6f} ({b_by}) achieved_GB_s="
                      f"{gb_s:.1f} share_of_bound={b_ms / k_ms:.3f} "
                      f"max_abs_err={err:.3g}", flush=True)
                if (n_frames, m) == (16, 32768):
                    at_main = dict(ms=k_ms, plain_ms=r_ms, bound_ms=b_ms,
                                   bound_by=b_by)
                    host_in = torch.empty(q.shape, dtype=q.dtype,
                                          pin_memory=True)
                    host_out = torch.empty(got.shape, dtype=got.dtype,
                                           pin_memory=True)
                    h2d = cuda_ms(lambda: q.copy_(host_in, non_blocking=True),
                                  iters=10)
                    d2h = cuda_ms(lambda: host_out.copy_(got,
                                                         non_blocking=True),
                                  iters=10)
                    print(f"copies F=16 M=32768 (pinned): h2d_ms={h2d:.6f} "
                          f"({q.numel() * 2} B) d2h_ms={d2h:.6f} "
                          f"({got.numel() * 4} B)", flush=True)
    small = torch.from_numpy(random_stream(rng, 1, 64, 8)).to(DEVICE)
    at_main["host_us"] = host_us(lambda: decode_gop_blocks(small, 8))
    at_main["max_abs_err"] = worst
    print(f"decode wrapper host cost: {at_main['host_us']:.3f} us/call",
          flush=True)
    return at_main


def encode_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.dct import dct_quant, dct_quant_ref
    from repro_torch.kernels.idct import idct_dequant, idct_dequant_ref

    rng = np.random.default_rng(seed + 1)
    worst = {"dct_quant": 0.0, "idct_dequant": 0.0}
    at_main = {}
    for n in (64, 4096, 32400, 131072):
        for qp in (4, 8, 16):
            for intra in (True, False):
                x = torch.from_numpy(pixel_blocks(rng, n, not intra))
                x = x.to(DEVICE)
                q = dct_quant(x, qp, intra)
                q_ref = dct_quant_ref(x, qp, intra)
                y = idct_dequant(q, qp, intra)
                y_ref = idct_dequant_ref(q, qp, intra)
                torch.cuda.synchronize()
                # both kernels round as their plain versions do, so the
                # outputs are equal, not close
                diff = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
                d_max = int(diff.max())
                check(torch.equal(q, q_ref),
                      f"dct_quant vs plain N={n} qp={qp} intra={intra}: "
                      f"{int((diff != 0).sum())} outputs differ, max |diff| "
                      f"{d_max}")
                err = (y - y_ref).abs()
                check(torch.equal(y, y_ref),
                      f"idct_dequant vs plain N={n} qp={qp} intra={intra}: "
                      f"max |diff| {float(err.max())}")
                worst["dct_quant"] = max(worst["dct_quant"], d_max)
                worst["idct_dequant"] = max(worst["idct_dequant"],
                                            float(err.max()))
                if qp != QP:
                    continue
                b_ms, b_by = bound_ms(n, BYTES_PER_BLOCK, FLOPS_PER_BLOCK)
                for name, kern, plain, arg in (
                        ("dct_quant", dct_quant, dct_quant_ref, x),
                        ("idct_dequant", idct_dequant, idct_dequant_ref, q)):
                    k_ms = cuda_ms(lambda: kern(arg, qp, intra), iters=50)
                    c_ms = cold_ms(lambda: kern(arg, qp, intra), iters=50)
                    r_ms = cuda_ms(lambda: plain(arg, qp, intra), iters=3,
                                   warmup=1)
                    print(f"{name} N={n:6d} qp={qp} intra={intra!s:5}: "
                          f"kernel_ms={k_ms:.6f} cold_ms={c_ms:.6f} "
                          f"ref_ms={r_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
                          f"share_of_bound={b_ms / c_ms:.3f} (cold) "
                          f"achieved_GB_s="
                          f"{n * BYTES_PER_BLOCK / c_ms / 1e6:.1f} (cold)",
                          flush=True)
                    # the main path's launches are mostly P-frames (inter)
                    if n == H * W // 64 and not intra:
                        at_main[name] = dict(ms=k_ms, plain_ms=r_ms,
                                             bound_ms=b_ms, bound_by=b_by)
    x = torch.from_numpy(pixel_blocks(rng, 64, True)).to(DEVICE)
    q = dct_quant(x, QP, False)
    at_main["dct_quant"]["host_us"] = host_us(
        lambda: dct_quant(x, QP, False))
    at_main["idct_dequant"]["host_us"] = host_us(
        lambda: idct_dequant(q, QP, False))
    for name in at_main:
        at_main[name]["max_abs_err"] = worst[name]
        print(f"{name} wrapper host cost: {at_main[name]['host_us']:.3f} "
              f"us/call", flush=True)
    return at_main


# -------------------------------------------------------------- path phases
def _assemble(tiles, rects, shape) -> np.ndarray:
    out = np.zeros(shape, dtype=np.float32)
    for (y1, x1, y2, x2), px in zip(rects, tiles):
        out[:, y1:y2, x1:x2] = px
    return out


def _encode_split(sot, rects, cfg) -> dict:
    """Device time of one SOT's encode, by kind, from the profiler (None
    where it recorded no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.codec.encode import encode_tiles

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        encode_tiles(sot, rects, cfg, device=DEVICE)
        torch.cuda.synchronize()
    split = {"dct_quant_ms": 0.0, "idct_dequant_ms": 0.0,
             "other_kernels_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.device_time_total / 1e3
        if "idct_dequant" in evt.key:
            split["idct_dequant_ms"] += ms
        elif "dct_quant" in evt.key:
            split["dct_quant_ms"] += ms
        elif "HtoD" in evt.key:
            split["h2d_ms"] += ms
        elif "DtoH" in evt.key:
            split["d2h_ms"] += ms
        else:
            split["other_kernels_ms"] += ms
    if split["dct_quant_ms"] == 0.0:
        return {k: None for k in split}
    return split


def ingest_phase(frames, dets) -> tuple:
    """(store, ingest launches): the 1080p ingest on the card, every SOT
    against the numpy encoder, and one SOT's encode split."""
    from repro_torch.codec.bitstream import stream_bytes_np
    from repro_torch.codec.encode import (EncoderConfig, decode_tile,
                                          encode_tile, encode_tiles)
    from repro_torch.codec.psnr import psnr
    from repro_torch.core import (CacheConfig, DecodeConfig, TuningConfig,
                                  VideoStore, uniform_layout)

    cfg = EncoderConfig(gop=GOP, qp=QP)
    # cache off: every scan of the scan and server phases decodes; tuning
    # off: the served and in-process scans see one layout
    store = VideoStore(decode=DecodeConfig(device=DEVICE),
                       cache=CacheConfig(budget_bytes=0),
                       tuning=TuningConfig(mode="off"))
    check(store.decode_backend == "batched"
          and store.decode_config.device.startswith(DEVICE),
          f"store decodes with {store.decode_backend} on "
          f"{store.decode_config.device}")
    layout = uniform_layout(H, W, *LAYOUT)
    check(layout.n_tiles == LAYOUT[0] * LAYOUT[1],
          f"layout has {layout.n_tiles} tiles")
    reset_counts()
    t0 = time.perf_counter()
    store.ingest("v", frames, detections=dets, encoder=cfg,
                 initial_layouts={s: layout for s in range(N_FRAMES // GOP)})
    ingest_s = time.perf_counter() - t0
    launches = read_counts()
    n_gops = N_FRAMES // GOP
    check(launches["dct_quant"] == N_FRAMES
          and launches["idct_dequant"] == N_FRAMES - n_gops
          and launches["decode_gop_blocks"] == 0,
          f"ingest launched {launches}, want {N_FRAMES} dct_quant and "
          f"{N_FRAMES - n_gops} idct_dequant")
    print(f"ingest {N_FRAMES}x{H}x{W}, {layout.n_tiles} tiles: "
          f"wall_s={ingest_s:.6f} launches={launches}", flush=True)

    # every SOT against the numpy encoder, tile by tile
    ts = store.video("v").store
    numpy_total = device_total = 0.0
    for rec in ts.sots:
        rects = rec.layout.tile_rects()
        sot = frames[rec.frame_start:rec.frame_end]
        stored = [ts._read_tile(rec, i) for i in range(len(rects))]
        t0 = time.perf_counter()
        again = encode_tiles(sot, rects, cfg, device=DEVICE)
        device_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = [encode_tile(np.ascontiguousarray(sot[:, y1:y2, x1:x2]), cfg)
               for y1, x1, y2, x2 in rects]
        numpy_s = time.perf_counter() - t0
        numpy_total += numpy_s
        device_total += device_s
        equal = total = 0
        for st, a, r in zip(stored, again, ref):
            for k in ("kq", "pq"):
                check(st[k].shape == r[k].shape and st[k].dtype == np.int16,
                      f"stored {k} {st[k].dtype}{st[k].shape}, want "
                      f"int16{r[k].shape}")
                check(np.array_equal(st[k], a[k]),
                      "device encode not repeatable")
                equal += int((st[k] == r[k]).sum())
                total += r[k].size
            check(st["size_bytes"] == a["size_bytes"],
                  "size_bytes not repeatable")
        share = equal / total
        p_dev = psnr(sot, _assemble([decode_tile(e) for e in stored], rects,
                                    sot.shape))
        p_ref = psnr(sot, _assemble([decode_tile(e) for e in ref], rects,
                                    sot.shape))
        print(f"ingest SOT {rec.sot_id} vs numpy encode_tile: "
              f"equal_share={share:.6f} ({total - equal} of {total} "
              f"coefficients differ) psnr_device_db={p_dev:.6f} "
              f"psnr_numpy_db={p_ref:.6f} encode_wall_s "
              f"device={device_s:.6f} numpy={numpy_s:.6f}", flush=True)
        check(share >= SHARE, f"SOT {rec.sot_id} equal share {share}")
        check(abs(p_dev - p_ref) <= PSNR_DB,
              f"SOT {rec.sot_id} PSNR {p_dev} vs numpy {p_ref}")
    print(f"ingest encode of all SOTs on this host's numpy: "
          f"wall_s={numpy_total:.6f}; again on the card: "
          f"wall_s={device_total:.6f}", flush=True)

    rec = ts.sots[0]
    rects = rec.layout.tile_rects()
    sot = frames[rec.frame_start:rec.frame_end]
    split = _encode_split(sot, rects, cfg)
    encs = [ts._read_tile(rec, i) for i in range(len(rects))]
    t0 = time.perf_counter()
    for e in encs:
        stream_bytes_np(e["kq"]) + stream_bytes_np(e["pq"])
    size_s = time.perf_counter() - t0
    if split["dct_quant_ms"] is None:
        share = "not measured"
    else:
        share = f"{split['other_kernels_ms'] / sum(split.values()):.3f}"
    print("ingest one SOT's encode, device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()) +
          f" other_kernels_share={share}; size model host_s={size_s:.6f}",
          flush=True)
    return store, launches


def _oracle_frames(ts) -> np.ndarray:
    """Every frame of the store, decoded tile by tile by the numpy oracle."""
    from repro_torch.codec.encode import decode_tile

    last = ts.sots[-1]
    out = np.zeros((last.frame_end, last.layout.frame_height,
                    last.layout.frame_width), dtype=np.float32)
    for rec in ts.sots:
        for i, (y1, x1, y2, x2) in enumerate(rec.layout.tile_rects()):
            out[rec.frame_start:rec.frame_end, y1:y2, x1:x2] = \
                decode_tile(ts._read_tile(rec, i))
    return out


def _check_regions(regions, oracle, what: str) -> float:
    check(len(regions) > 0, f"{what}: no regions")
    worst = 0.0
    for frame, (y1, x1, y2, x2), px in regions:
        want = oracle[frame, y1:y2, x1:x2]
        check(px.dtype == np.float32 and px.shape == want.shape,
              f"{what}: region {frame} {(y1, x1, y2, x2)} is "
              f"{px.dtype}{px.shape}, want float32{want.shape}")
        np.testing.assert_allclose(px, want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} frame {frame}")
        worst = max(worst, float(np.abs(px - want).max(initial=0.0)))
    return worst


def _check_identical(a, b, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} regions")
    for ra, rb in zip(a, b):
        check(ra[:-1] == rb[:-1] and np.array_equal(ra[-1], rb[-1]),
              f"{what}: region {ra[:-1]} differs")


def _scan_split(store) -> dict:
    """Device time of one more full-frame scan, by kind, from the profiler
    (None where it recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        store.scan("v").labels("frame").frames(0, N_FRAMES).execute()
        torch.cuda.synchronize()
    split = {"kernel_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0}
    for evt in prof.key_averages():
        us = evt.device_time_total
        name = evt.key
        if "decode_gop_blocks" in name:
            split["kernel_ms"] += us / 1e3
        elif "HtoD" in name:
            split["h2d_ms"] += us / 1e3
        elif "DtoH" in name:
            split["d2h_ms"] += us / 1e3
    if split["kernel_ms"] == 0.0:
        return {k: None for k in split}
    return split


def scan_phase(store) -> tuple:
    """(launches, oracle frames): the scan paths against the oracle."""
    n = N_FRAMES
    store.add_detections("v", {f: [("frame", (0, 0, H, W))]
                               for f in range(n)})
    t0 = time.perf_counter()
    oracle = _oracle_frames(store.video("v").store)
    oracle_s = time.perf_counter() - t0

    queries = [("car", (0, 64)), ("person", (8, 40)), ("car", (16, 48)),
               ("frame", (30, 34))]
    worst = 0.0
    per_phase = {}

    def timed(name, fn):
        before = read_counts()["decode_gop_blocks"]
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_phase[name] = dict(
            wall_s=time.perf_counter() - t,
            launches=read_counts()["decode_gop_blocks"] - before)
        return out

    reset_counts()
    full = timed("full_frame_scan", lambda: store.scan("v").labels("frame")
                 .frames(0, n).execute())
    roi = timed("label_scan", lambda: store.scan("v").labels("car")
                .frames(0, n).execute())
    serial = timed("serial_four", lambda: [
        store.scan("v").labels(l).frames(*f).execute() for l, f in queries])
    merged = timed("execute_many_four", lambda: store.execute_many(
        [store.scan("v").labels(l).frames(*f) for l, f in queries]))

    def serve():
        with store.serve() as session:
            futs = [session.submit(store.scan("v").labels(l).frames(*f))
                    for l, f in queries]
            return [f.result(timeout=300) for f in futs]

    served = timed("serve_four", serve)
    launches = read_counts()

    check(len(full.regions) == n, f"full-frame scan: {len(full.regions)} "
                                  f"regions, want {n}")
    check(per_phase["full_frame_scan"]["launches"] == n // GOP,
          f"full-frame scan launched {per_phase['full_frame_scan']} times, "
          f"want one per SOT ({n // GOP})")
    worst = max(worst, _check_regions(full.regions, oracle, "full-frame"))
    worst = max(worst, _check_regions(roi.regions, oracle, "label scan"))
    for (lbl, fr), s, m, v in zip(queries, serial, merged, served):
        worst = max(worst, _check_regions(s.regions, oracle,
                                          f"serial {lbl}{fr}"))
        _check_identical(s.regions, m.regions, f"execute_many {lbl}{fr}")
        _check_identical(s.regions, v.regions, f"serve {lbl}{fr}")
    check(launches["decode_gop_blocks"] > 0,
          "the scan path never launched the decode kernel")
    for name, p in per_phase.items():
        check(p["launches"] > 0, f"{name} never launched the kernel")
        print(f"scan {name}: wall_s={p['wall_s']:.6f} "
              f"launches={p['launches']}", flush=True)
    split = _scan_split(store)
    store.close()
    print("scan full-frame device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()), flush=True)
    print(f"scan setup: oracle_s={oracle_s:.3f} "
          f"regions_checked max_abs_err={worst:.3g}", flush=True)
    return launches, oracle


# ------------------------------------------------------------ video serving
def _shm_pool_bytes() -> int:
    """A shared-memory pool budget within the free space of /dev/shm: a
    reply written past a full tmpfs would fault, so the pool stays at half
    the free space (replies beyond it ride the npz payload)."""
    st = os.statvfs("/dev/shm")
    return min(1 << 30, st.f_bavail * st.f_frsize // 2)


def video_server_phase(store, oracle) -> None:
    """The 1080p, 48-tile store served in-process through the port's
    ``VideoStoreServer`` on a Unix socket, driven by client threads, each
    with its own ``RemoteVideoStore``, once per transport, and once more
    over the socket with the JSON codec where msgpack is the default;
    every reply is held bit for bit against the same scan in-process."""
    from repro_torch.core import RemoteVideoStore, VideoStoreServer, wire
    from repro_torch.core.shm import shm_available

    want = {}
    for lbl, fr in SERVER_QUERIES:
        res = store.scan("v").labels(lbl).frames(*fr).execute()
        _check_regions(res.regions, oracle, f"server reference {lbl}{fr}")
        want[(lbl, fr)] = res.regions
    default = wire.default_codec()
    passes = [("socket", default)] + (
        [("shm", default)] if shm_available() else []) + (
        [("socket", "json")] if default != "json" else [])
    pool_bytes = _shm_pool_bytes() if shm_available() else 0
    print(f"server: default codec={default} msgpack="
          f"{wire._msgpack is not None} passes={passes} "
          f"shm_pool_bytes={pool_bytes}", flush=True)
    tmp = tempfile.mkdtemp(prefix="tasm")
    try:
        for transport, codec in passes:
            sock = os.path.join(tmp, f"{transport}_{codec}.sock")
            lat, seen, errors = [], [], []
            lock = threading.Lock()

            def client(k):
                try:
                    with RemoteVideoStore(sock, transport=transport,
                                          timeout=600) as cli:
                        for i in range(SERVER_REQUESTS):
                            q = SERVER_QUERIES[(k + i) % len(SERVER_QUERIES)]
                            t0 = time.perf_counter()
                            res = cli.scan("v").labels(q[0]) \
                                .frames(*q[1]).execute()
                            dt = time.perf_counter() - t0
                            _check_identical(want[q], res.regions,
                                             f"{transport} client {k} {q}")
                            with lock:
                                lat.append(dt)
                                seen.append((res.stats.transport,
                                             res.stats.payload_bytes))
                            del res
                except BaseException as e:  # noqa: BLE001 - raised below
                    errors.append(e)

            with VideoStoreServer(store, path=sock, owns_store=False,
                                  codec=codec,
                                  shm_max_bytes=max(pool_bytes, 1)):
                reset_counts()
                threads = [threading.Thread(target=client, args=(k,))
                           for k in range(SERVER_CLIENTS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
                wall = time.perf_counter() - t0
                launches = read_counts()
            check(not any(t.is_alive() for t in threads),
                  f"{transport}: a client hung")
            if errors:
                raise errors[0]
            n = SERVER_CLIENTS * SERVER_REQUESTS
            check(len(lat) == n, f"{transport}: {len(lat)} of {n} replies")
            check(launches["decode_gop_blocks"] > 0,
                  f"{transport}: served scans never launched the decode "
                  f"kernel: {launches}")
            by = {}
            for t, _ in seen:
                by[t] = by.get(t, 0) + 1
            p50, p95 = np.percentile(lat, [50, 95])
            print(f"server {transport}: {SERVER_CLIENTS} clients x "
                  f"{SERVER_REQUESTS} requests, wall_s={wall:.6f} "
                  f"requests_per_s={n / wall:.3f} latency_p50_s={p50:.6f} "
                  f"latency_p95_s={p95:.6f} latency_max_s={max(lat):.6f} "
                  f"reply_bytes={int(sum(b for _, b in seen))} "
                  f"replies_by_transport={by} codec={codec} "
                  f"decode_launches={launches['decode_gop_blocks']} "
                  f"(bit-identical to in-process)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _port_env() -> dict:
    """The environment of a port subprocess: this checkout's ``src``
    first on ``PYTHONPATH``."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))


def cli_server_phase(seed: int) -> None:
    """``python -m repro_torch.tasm_serve --device cuda`` as a subprocess
    over a small store root: ``ping``, ``config()``, one scan, and a clean
    exit on ``shutdown_server()``; every wait has a timeout."""
    from repro_torch.codec.encode import decode_tile
    from repro_torch.core import (DecodeConfig, NoTilingPolicy,
                                  RemoteVideoStore, TuningConfig, VideoStore)
    from repro_torch.data.video_gen import generate, sparse_spec

    h, w, n = CLI_SPEC
    frames, dets = generate(sparse_spec(seed=seed + 5, height=h, width=w,
                                        n_frames=n))
    tmp = tempfile.mkdtemp(prefix="tasm")
    root, sock = os.path.join(tmp, "root"), os.path.join(tmp, "cli.sock")
    local = VideoStore(store_root=root, decode=DecodeConfig(device=DEVICE),
                       tuning=TuningConfig(mode="off"))
    local.ingest("cam", frames, detections=dets, policy=NoTilingPolicy())
    want = local.scan("cam").labels("car").frames(0, n).execute().regions
    ts = local.video("cam").store
    oracle = np.zeros((n, h, w), np.float32)
    for rec in ts.sots:
        for i, (y1, x1, y2, x2) in enumerate(rec.layout.tile_rects()):
            oracle[rec.frame_start:rec.frame_end, y1:y2, x1:x2] = \
                decode_tile(ts._read_tile(rec, i))
    local.close()
    env = _port_env()
    cmd = [sys.executable, "-m", "repro_torch.tasm_serve", "--device",
           DEVICE, "--socket", sock, "--store-root", root, "--tuning", "off"]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.perf_counter()
        while not os.path.exists(sock):
            if proc.poll() is not None:
                raise AssertionError(f"tasm_serve exited {proc.returncode} "
                                     f"before serving: {proc.stdout.read()}")
            check(time.perf_counter() - t0 < 180,
                  "tasm_serve's socket never appeared")
            time.sleep(0.05)
        start_s = time.perf_counter() - t0
        with RemoteVideoStore(sock, timeout=300) as cli:
            pong = cli.ping()
            cfg = cli.config()
            t1 = time.perf_counter()
            res = cli.scan("cam").labels("car").frames(0, n).execute()
            scan_s = time.perf_counter() - t1
            cli.shutdown_server()
        rc = proc.wait(timeout=120)
        log = proc.stdout.read().strip()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    check(pong.get("pong") is True, f"tasm_serve ping: {pong}")
    check(cfg["decode"].device.startswith(DEVICE),
          f"tasm_serve decodes on {cfg['decode'].device}")
    _check_identical(want, res.regions, "tasm_serve scan")
    worst = _check_regions(res.regions, oracle, "tasm_serve scan")
    check(rc == 0, f"tasm_serve exited {rc}")
    print(f"tasm_serve subprocess ({h}x{w}, {n} frames): {log!r}; "
          f"start_s={start_s:.3f} scan_s={scan_s:.6f} regions="
          f"{len(res.regions)} max_abs_err={worst:.3g} decode="
          f"{cfg['decode']} exit={rc}", flush=True)


# ---------------------------------------------------------------- cluster
def _contexts() -> tuple:
    """(processes holding a context on the card, memory used on it) from
    ``nvidia-smi``.  In a container ``--query-compute-apps`` may list every
    context under one pid, so the phase counts its lines and tells the
    processes apart by their open device files (:func:`_device_files`)."""
    def smi(query):
        return subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip().splitlines()

    apps = [line for line in smi("--query-compute-apps=pid,used_memory")
            if line.strip()]
    return len(apps), smi("--query-gpu=memory.used")[0].strip()


def _device_files(pid: int) -> list:
    """The NVIDIA device files process ``pid`` holds open: none for a
    process that never touched the card (importing torch opens none)."""
    out = []
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return out


def _busy_while(fn) -> tuple:
    """(``fn()``, the card's ``utilization.gpu`` samples while it ran):
    ``nvidia-smi`` every 200 ms, each sample the percent of its period in
    which a kernel of any process ran on the card."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu",
                            "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        smi.terminate()
        text, _ = smi.communicate(timeout=60)
    samples = [int(x) for x in text.split() if x.isdigit()]
    check(samples, f"nvidia-smi gave no utilization sample: {text!r}")
    return out, samples


def _shm_names() -> set:
    return set(os.listdir("/dev/shm"))


class _Procs:
    """The cluster phase's subprocesses, each logging to a file and waited
    for until its socket appears; :meth:`close` kills what is left."""

    def __init__(self, tmp: str):
        self.tmp, self.procs, self.socks = tmp, {}, {}

    def start(self, name: str, args: list) -> str:
        sock = os.path.join(self.tmp, f"{name}.sock")
        with open(os.path.join(self.tmp, f"{name}.log"), "w") as log:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", *args, "--socket", sock],
                env=_port_env(), cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT)
        self.socks[name] = sock
        return sock

    def node(self, name: str) -> str:
        return self.start(name, [
            "repro_torch.tasm_serve", "--device", DEVICE, "--tuning", "off",
            "--cache-bytes", "0", "--max-frame-mb", str(CLUSTER_FRAME_MB),
            "--store-root", os.path.join(self.tmp, f"store-{name}")])

    def wait_ready(self, names, timeout: float = 180) -> float:
        t0 = time.perf_counter()
        for name in names:
            while not os.path.exists(self.socks[name]):
                check(self.procs[name].poll() is None,
                      f"{name} exited {self.procs[name].returncode} before "
                      f"serving: {self.log(name)}")
                check(time.perf_counter() - t0 < timeout,
                      f"{name}: its socket never appeared")
                time.sleep(0.05)
        return time.perf_counter() - t0

    def pid(self, name: str) -> int:
        return self.procs[name].pid

    def log(self, name: str) -> str:
        with open(os.path.join(self.tmp, f"{name}.log")) as f:
            return f.read()[-4000:]

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


def _router_admin(router_sock: str, *args: str) -> tuple:
    """``python -m repro_torch.tasm_router`` in an admin mode against the
    running router: (exit code, output, wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.tasm_router",
                          "--socket", router_sock, *args], env=_port_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    return (out.returncode, (out.stdout + out.stderr).strip(),
            time.perf_counter() - t0)


def _cluster_wave(opener, route, queries, want, what: str,
                  on_reply=None) -> tuple:
    """4 client threads, 8 requests each cycling over ``queries``; a
    thread sends a query to ``route(camera)`` over its own client
    ``opener(address)`` and holds every reply bit for bit against
    ``want``; ``on_reply`` sees the count of replies so far.  Returns
    (latencies, wall seconds, reply bytes)."""
    lat, errors, nbytes = [], [], []
    lock = threading.Lock()

    def client(k):
        clients = {}
        try:
            for i in range(SERVER_REQUESTS):
                q = queries[(k + i) % len(queries)]
                cam, lbl, fr = q
                addr = route(cam)
                if addr not in clients:
                    clients[addr] = opener(addr)
                t0 = time.perf_counter()
                res = clients[addr].scan(cam).labels(lbl).frames(*fr) \
                    .execute()
                dt = time.perf_counter() - t0
                _check_identical(want[q], res.regions,
                                 f"{what} client {k} {q}")
                with lock:
                    lat.append(dt)
                    nbytes.append(res.stats.payload_bytes)
                    done = len(lat)
                del res
                if on_reply is not None:
                    on_reply(done)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            for c in clients.values():
                c.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVER_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), f"{what}: a client hung")
    if errors:
        raise errors[0]
    n = SERVER_CLIENTS * SERVER_REQUESTS
    check(len(lat) == n, f"{what}: {len(lat)} of {n} replies")
    return lat, wall, int(sum(nbytes))


def _wave_line(what, wave, busy) -> str:
    lat, wall, nbytes = wave
    p50, p95 = np.percentile(lat, [50, 95])
    return (f"{what}: {len(lat)} requests, wall_s={wall:.6f} "
            f"requests_per_s={len(lat) / wall:.3f} latency_p50_s={p50:.6f} "
            f"latency_p95_s={p95:.6f} latency_max_s={max(lat):.6f} "
            f"reply_bytes={nbytes} card_busy_pct mean "
            f"{np.mean(busy):.1f} max {max(busy)} over {len(busy)} samples")


def cluster_phase(seed: int) -> None:
    """Three ``tasm_serve --device cuda`` node processes behind one
    ``tasm_router`` process (K=2) on this card: routed ingest of three
    1080p cameras, routed scans from 4 client threads (beside the same
    requests sent straight to the nodes), a SIGKILL of cam0's primary
    under load, a routed retile, a fourth node joined and repaired onto
    through the router's CLI, the device checks of ``nvidia-smi``, and a
    clean SIGTERM of every process.  Replies are held bit for bit against
    an in-process store on the card and within tolerance of the numpy
    oracle; every wait has a timeout."""
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core import (CacheConfig, ClusterClient, DecodeConfig,
                                  NoTilingPolicy, RemoteVideoStore,
                                  TuningConfig, VideoStore, uniform_layout)
    from repro_torch.core.shm import DEFAULT_POOL_BYTES
    from repro_torch.data.video_gen import generate, sparse_spec

    t_phase = time.perf_counter()
    # five socket servers (four nodes, the router) may each pool up to
    # DEFAULT_POOL_BYTES of replies in /dev/shm, which is never checked
    # against the tmpfs's free space: demand twice that, or stop here
    st = os.statvfs("/dev/shm")
    free, pools = st.f_bavail * st.f_frsize, 5 * DEFAULT_POOL_BYTES
    check(free >= 2 * pools,
          f"cluster: /dev/shm has {free} bytes free, want at least "
          f"{2 * pools} (twice the five servers' shm pools)")
    shm_before = _shm_names()
    enc = EncoderConfig(gop=GOP, qp=QP)
    h, w, n = H, W, CLUSTER_FRAMES
    cams = [f"cam{k}" for k in range(CLUSTER_CAMS)]
    layouts = {s: uniform_layout(h, w, *LAYOUT) for s in range(n // GOP)}
    full = {f: [("frame", (0, 0, h, w))] for f in range(n)}
    t0 = time.perf_counter()
    video = {cam: generate(sparse_spec(seed=seed + 10 + k, height=h,
                                       width=w, n_frames=n))
             for k, cam in enumerate(cams)}
    gen_s = time.perf_counter() - t0
    queries = ([(cam, "car", (0, n)) for cam in cams]
               + [(cam, "person", (8, 24)) for cam in cams]
               + [("cam1", "frame", (0, 16))])

    counted, used0 = _contexts()
    check(counted <= 1, f"cluster: {counted} contexts on the card before "
                        f"the phase")
    tmp = tempfile.mkdtemp(prefix="tasm")
    procs = _Procs(tmp)
    ref = None
    ok = False
    try:
        node_socks = {name: procs.node(name) for name in ("a", "b", "c")}
        start_s = procs.wait_ready(node_socks)
        router = procs.start("router", [
            "repro_torch.tasm_router", "--replication", "2", "--timeout",
            "300", "--max-frame-mb", str(CLUSTER_FRAME_MB), "--placement",
            os.path.join(tmp, "placement.json"),
            *[a for name, s in node_socks.items()
              for a in ("--node", f"{name}={s}")]])
        procs.wait_ready(["router"])

        def cluster_client(addr=router):
            return ClusterClient(addr, timeout=600,
                                 max_frame_bytes=CLUSTER_FRAME_MB << 20)

        def node_client(addr):
            return RemoteVideoStore(addr, timeout=600,
                                    max_frame_bytes=CLUSTER_FRAME_MB << 20)

        # 1. routed ingest: every camera onto 2 of the 3 nodes
        t0 = time.perf_counter()
        per_cam = {}

        def ingest():
            with cluster_client() as cc:
                for cam in cams:
                    frames, dets = video[cam]
                    cc.add_video(cam, encoder=enc, policy=NoTilingPolicy())
                    t1 = time.perf_counter()
                    stats = cc.ingest(cam, frames, detections=dets,
                                      initial_layouts=layouts)
                    per_cam[cam] = (round(time.perf_counter() - t1, 6),
                                    round(stats.encode_s, 6))
                cc.add_detections("cam1", full)
                return cc.placement()["assignments"]

        placement, busy = _busy_while(ingest)
        ingest_s = time.perf_counter() - t0
        check(sorted(placement) == cams
              and all(len(set(r)) == 2 for r in placement.values()),
              f"cluster placement {placement}")
        print(f"cluster: 3 nodes up in {start_s:.3f} s; routed ingest of "
              f"{len(cams)} cameras x {n}x{h}x{w}, "
              f"{layouts[0].n_tiles} tiles, K=2: wall_s={ingest_s:.6f} "
              f"(per camera: wall_s and one replica's encode_s "
              f"{per_cam}; generate_s={gen_s:.3f}) card_busy_pct mean "
              f"{np.mean(busy):.1f} max {max(busy)} over {len(busy)} "
              f"samples; placement={placement}", flush=True)

        # 2-3. the in-process store on the card, and the numpy oracle
        reset_counts()
        ref = VideoStore(decode=DecodeConfig(device=DEVICE),
                         cache=CacheConfig(budget_bytes=0),
                         tuning=TuningConfig(mode="off"))
        t0 = time.perf_counter()
        for cam in cams:
            frames, dets = video[cam]
            ref.ingest(cam, frames, detections=dets, encoder=enc,
                       policy=NoTilingPolicy(), initial_layouts=layouts)
        ref_ingest_s = time.perf_counter() - t0
        ref.add_detections("cam1", full)
        del video
        counted, used = _contexts()
        check(counted == 1 + len(node_socks),
              f"cluster: {counted} contexts on the card after the ingest, "
              f"want this process's and one per node ({1 + len(node_socks)})")
        check(not _device_files(procs.pid("router")),
              f"cluster: the router opened the card: "
              f"{_device_files(procs.pid('router'))}")
        mem = {"before the nodes": used0, "3 nodes": used}
        print(f"cluster: the same ingest in this process: wall_s="
              f"{ref_ingest_s:.6f}; {counted} contexts on the card",
              flush=True)
        oracle = {cam: _oracle_frames(ref.video(cam).store) for cam in cams}
        want, worst = {}, 0.0
        for q in queries:
            cam, lbl, fr = q
            res = ref.scan(cam).labels(lbl).frames(*fr).execute()
            worst = max(worst, _check_regions(res.regions, oracle[cam],
                                              f"cluster reference {q}"))
            want[q] = res.regions
        del oracle

        # 4. routed scans, then the same requests straight to the nodes
        routed = _busy_while(lambda: _cluster_wave(
            cluster_client, lambda cam: router, queries, want,
            "cluster routed"))
        direct = _busy_while(lambda: _cluster_wave(
            node_client, lambda cam: node_socks[placement[cam][0]],
            queries, want, "cluster direct"))
        hop = (np.percentile(routed[0][0], 50)
               - np.percentile(direct[0][0], 50))
        print(_wave_line("cluster scans through the router, 4 clients x "
                         f"{SERVER_REQUESTS}", *routed) + " | " +
              _wave_line("straight to each camera's primary", *direct) +
              f" | router hop p50_s={hop:.6f} (bit-identical to "
              f"in-process, max_abs_err vs numpy oracle {worst:.3g})",
              flush=True)

        # 5. SIGKILL cam0's primary while a second wave is in flight
        dead = placement["cam0"][0]
        killed = threading.Event()

        def kill_mid_wave(done):
            if done >= SERVER_CLIENTS and not killed.is_set():
                killed.set()
                procs.procs[dead].kill()

        failover = _busy_while(lambda: _cluster_wave(
            cluster_client, lambda cam: router, queries, want,
            "cluster failover", on_reply=kill_mid_wave))
        check(killed.is_set(), "cluster: the primary was never killed")
        check(procs.procs[dead].wait(timeout=60) == -9,
              f"cluster: node {dead} was not killed")
        with cluster_client() as cc:
            health = cc.node_health()
        check(health.get(dead) is False and all(
            v for k, v in health.items() if k != dead),
              f"cluster: node_health after the kill: {health}")
        t0 = time.perf_counter()
        while _contexts()[0] != len(node_socks):
            check(time.perf_counter() - t0 < 30,
                  f"cluster: {_contexts()[0]} contexts 30 s after the "
                  f"kill, want {len(node_socks)}")
            time.sleep(0.5)
        released_s = time.perf_counter() - t0
        mem["after the kill"] = _contexts()[1]
        print(_wave_line(f"cluster failover wave (SIGKILL of {dead}, "
                         f"cam0's primary, after {SERVER_CLIENTS} replies)",
                         *failover) +
              f" failed_reads=0 node_health={health} "
              f"context_released_s={released_s:.3f}", flush=True)

        # 6. a routed retile: the surviving replica re-encodes on the card
        new_layout = uniform_layout(h, w, *CLUSTER_RETILE)
        with cluster_client() as cc:
            t0 = time.perf_counter()
            cc.retile("cam0", 0, new_layout)
            retile_s = time.perf_counter() - t0
            epochs = cc.epochs("cam0")
        ref.retile("cam0", 0, new_layout)
        check(epochs == ref.epochs("cam0") and epochs[0] >= 1,
              f"cluster: routed retile epochs {epochs}, in-process "
              f"{ref.epochs('cam0')}")

        # 7. a fresh node joins, and the CLI repairs onto it
        d_sock = procs.node("d")
        procs.wait_ready(["d"])
        rc, out, join_s = _router_admin(router, "--join-node", f"d={d_sock}")
        check(rc == 0, f"cluster: --join-node exited {rc}: {out}")
        rc, out, repair_s = _router_admin(router, "--repair", f"node={dead}",
                                          "--wait", "300")
        check(rc == 0, f"cluster: --repair exited {rc}: {out}")
        with cluster_client() as cc:
            status = cc.repair_status()
            placement = cc.placement()["assignments"]
        jobs = status["jobs"]
        check(jobs and all(j["status"] == "done" for j in jobs)
              and any(j["dst"] == "d" for j in jobs),
              f"cluster: repair jobs {jobs}")
        check(all(len(r) == 2 and dead not in r for r in placement.values()),
              f"cluster: placement after the repair {placement}")
        # each copy straight from the replica it built (the ring walk, not
        # the phase, picks a copy's destination among the live nodes)
        socks = dict(node_socks, d=d_sock)
        for j in jobs:
            cam = j["video"]
            cam_oracle = _oracle_frames(ref.video(cam).store)
            with node_client(socks[j["dst"]]) as dd:
                check(dd.epochs(cam) == ref.epochs(cam),
                      f"cluster: node {j['dst']} serves {cam} at epochs "
                      f"{dd.epochs(cam)}, want {ref.epochs(cam)}")
                for q in queries:
                    if q[0] != cam:
                        continue
                    got = dd.scan(cam).labels(q[1]).frames(*q[2]).execute()
                    _check_identical(ref.scan(cam).labels(q[1])
                                     .frames(*q[2]).execute().regions,
                                     got.regions,
                                     f"cluster node {j['dst']} {q}")
                    _check_regions(got.regions, cam_oracle,
                                   f"cluster node {j['dst']} {q}")
            del cam_oracle
        print(f"cluster: retile of cam0 SOT 0 to {CLUSTER_RETILE} through "
              f"the router retile_s={retile_s:.6f} epochs={epochs}; "
              f"--join-node d {join_s:.3f} s, --repair node={dead} "
              f"{repair_s:.3f} s: " + "; ".join(
                  f"{j['video']} {j['src']}->{j['dst']} chunks "
                  f"{j['chunks_done']}/{j['chunks_total']} bytes "
                  f"{int(j['bytes_copied'])} retries {j['retries']} "
                  f"restreams {j['restreams']}" for j in jobs) +
              f"; copy_s={status['stats']['copy_s']:.6f}; placement="
              f"{placement}; each copy read straight from its new replica "
              f"at the router's epochs, bit-identical", flush=True)

        # 8. device checks: every live node on the card, the router not
        with cluster_client() as cc:
            cfg = cc.config()["nodes"]
        live = [m for m in ("a", "b", "c", "d") if m != dead]
        check(cfg.get(dead) is None and all(
            cfg[m] is not None and cfg[m]["decode"].device.startswith(DEVICE)
            for m in live), f"cluster: node configs {cfg}")
        counted, mem["4 nodes, one dead"] = _contexts()
        check(counted == 1 + len(live),
              f"cluster: {counted} contexts on the card, want this "
              f"process's and one per live node ({1 + len(live)})")
        files = {m: len(_device_files(procs.pid(m)))
                 for m in live + ["router"]}
        check(files["router"] == 0 and all(files[m] for m in live),
              f"cluster: NVIDIA device files open per process: {files}")
        print(f"cluster device: {counted} contexts on the card (this "
              f"process and nodes {live}, each decoding on "
              f"{sorted({cfg[m]['decode'].device for m in live})}); "
              f"device files open {files}, none by the router (pid "
              f"{procs.pid('router')}); card memory used {mem} (per "
              f"process: not measured, nvidia-smi lists every context "
              f"under one pid here)", flush=True)

        # 9. SIGTERM: the router, then the nodes, each exits 0
        for m in ["router"] + live:
            procs.procs[m].send_signal(signal.SIGTERM)
            rc = procs.procs[m].wait(timeout=120)
            check(rc == 0, f"cluster: {m} exited {rc}: {procs.log(m)}")
            check(not os.path.exists(procs.socks[m]),
                  f"cluster: {m} left its socket behind")
        ok = True
    finally:
        if not ok:
            for m in procs.procs:
                print(f"cluster: {m} log tail: {procs.log(m)!r}",
                      file=sys.stderr, flush=True)
        procs.close()
        if ref is not None:
            ref.close()
        shutil.rmtree(tmp, ignore_errors=True)
    left = sorted(_shm_names() - shm_before)
    check(not left, f"cluster: shared-memory segments left behind: {left}")
    print(f"cluster phase: wall_s={time.perf_counter() - t_phase:.3f} "
          f"in-process reference launches={read_counts()}", flush=True)


def retile_phase(frames, dets, mode: str) -> dict:
    """Regret-driven retiles of the 1080p video under ``mode`` tuning; the
    new tiles must come from the encode kernels and scan right."""
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core import (CacheConfig, DecodeConfig, RegretPolicy,
                                  TuningConfig, VideoStore)
    from repro_torch.core.cost import CostModel

    store = VideoStore(decode=DecodeConfig(device=DEVICE),
                       tuning=TuningConfig(mode=mode),
                       cache=CacheConfig(budget_bytes=0))
    store.ingest("r", frames[:RETILE_FRAMES], detections=dets[:RETILE_FRAMES],
                 encoder=EncoderConfig(gop=GOP, qp=QP),
                 policy=RegretPolicy(),
                 cost_model=CostModel(beta=1.4e-8, gamma=1e-5))
    ts = store.video("r").store
    ingest_s = ts.encode_seconds_total
    reset_counts()
    t0 = time.perf_counter()
    scans = 0
    while not any(store.epochs("r").values()) and scans < 24:
        store.scan("r").labels("car").frames(0, RETILE_FRAMES).execute()
        store.drain_tuner(timeout=600)
        scans += 1
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    epochs = store.epochs("r")
    check(any(epochs.values()), f"{mode}: no retile after {scans} scans")
    check(launches["dct_quant"] > 0 and launches["idct_dequant"] > 0,
          f"{mode} retile did not encode through the kernels: {launches}")
    retile_s = ts.encode_seconds_total - ingest_s
    oracle = _oracle_frames(ts)
    res = store.scan("r").labels("car").frames(0, RETILE_FRAMES).execute()
    worst = _check_regions(res.regions, oracle, f"after {mode} retile")
    layouts = {r.sot_id: (r.layout.n_tiles, r.epoch) for r in ts.sots}
    store.close()
    print(f"retile {mode}: scans={scans} wall_s={wall_s:.6f} "
          f"retile_encode_s={retile_s:.6f} layouts(tiles, epoch)="
          f"{layouts} launches={launches} regions_checked "
          f"max_abs_err={worst:.3g}", flush=True)
    return launches


def calibration_phase() -> None:
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core.calibrate import calibrated_cost_model

    t0 = time.perf_counter()
    model = calibrated_cost_model(EncoderConfig(gop=GOP, qp=QP),
                                  device=DEVICE, repeats=10)
    print(f"calibration ({time.perf_counter() - t0:.3f} s): "
          f"beta={model.beta!r} gamma={model.gamma!r} "
          f"r_squared={model.r_squared!r} "
          f"encode_per_pixel={model.encode_per_pixel!r} "
          f"encode_per_tile={model.encode_per_tile!r} "
          f"io_per_pixel={model.io_per_pixel!r}", flush=True)
    for k in ("beta", "encode_per_pixel"):
        v = getattr(model, k)
        check(np.isfinite(v) and v > 0, f"calibrated {k}={v}")
    # the batched decode opens every tile of a SOT in one dispatch: on the
    # card the least-squares gamma comes out negative and the fit clamps it
    # to 0, so gamma is held to finite and non-negative
    check(np.isfinite(model.gamma) and model.gamma >= 0,
          f"calibrated gamma={model.gamma}")


# ------------------------------------------------------ attention and serving
def _qkv(rng, b, h, kv, s, d, dtype):
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(DEVICE, dtype)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


def flash_bound_ms(shape, dtype, causal: bool) -> tuple[float, str]:
    """Least time for one attention: q, k, v read and o written once over
    the HBM rate, against the products these inputs need (QK^T and PV, 2
    FLOPs per multiply-add, over the live (query, key) pairs) over the
    card's peak for their type."""
    b, h, kv, s, d = shape
    elt = torch.finfo(dtype).bits // 8
    n_bytes = b * s * d * (2 * h + 2 * kv) * elt
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(seed + 2)
    worst = 0.0
    timed = {}
    for shape in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(rng, *shape, dtype)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                check(err <= FLASH_TOL[dtype],
                      f"flash_attention vs plain {shape} {dtype} causal="
                      f"{causal}: max |diff| {err} > {FLASH_TOL[dtype]}")
                worst = max(worst, err)
            if shape not in (FLASH_MAIN, FLASH_LONG) \
                    or dtype != torch.bfloat16:
                continue
            k_ms = cuda_ms(lambda: flash_attention(q, k, v), iters=20)
            r_ms = cuda_ms(lambda: attention_ref(q, k, v), iters=3,
                           warmup=1)
            l_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True), iters=20)
            b_ms, b_by = flash_bound_ms(shape, dtype, True)
            t_bytes = flash_bound_ms(shape, dtype, False)
            print(f"flash_attention {shape} bf16 causal: kernel_ms="
                  f"{k_ms:.6f} plain_ms={r_ms:.6f} sdpa_ms={l_ms:.6f} "
                  f"bound_ms={b_ms:.6f} ({b_by}) share_of_bound="
                  f"{b_ms / k_ms:.3f} (non-causal bound "
                  f"{t_bytes[0]:.6f} ms, {t_bytes[1]})", flush=True)
            timed[shape] = dict(ms=k_ms, plain_ms=r_ms, library_ms=l_ms,
                                bound_ms=b_ms, bound_by=b_by)
    q, k, v = _qkv(rng, 1, 9, 3, 16, 64, torch.bfloat16)
    at_main = dict(timed[FLASH_MAIN], max_abs_err=worst,
                   host_us=host_us(lambda: flash_attention(q, k, v)),
                   long_ms=timed[FLASH_LONG]["ms"])
    print(f"flash_attention max_abs_err={worst:.3g} wrapper host cost: "
          f"{at_main['host_us']:.3f} us/call", flush=True)
    return at_main


# ------------------------------------------------------------ motion search
def sad_bound_ms(n: int, b: int, r: int) -> tuple[float, str]:
    """Least time for one search: blocks and windows read and the three
    [N] outputs written once over the HBM rate, against the two fp32 adds
    (a subtract, an add of the absolute value) of every (pixel, candidate)
    pair over the card's fp32 add rate."""
    w = b + 2 * r
    n_bytes = n * 4 * (b * b + w * w) + 12 * n
    adds = 2 * n * (2 * r + 1) ** 2 * b * b
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, adds / FP32_ADDS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sad_at(cur, win, dy, dx):
    """The plain SAD of candidate (dy[n], dx[n]) of every block n."""
    b = cur.shape[-1]
    idx = torch.arange(b, device=cur.device)
    rows = dy.long()[:, None] + idx
    cols = dx.long()[:, None] + idx
    cand = win[torch.arange(cur.shape[0], device=cur.device)[:, None, None],
               rows[:, :, None], cols[:, None, :]]
    return (cur - cand).abs().sum(dim=(1, 2))


def check_sad(got, want, cur, win, what: str, exact: bool) -> int:
    """Hold a search result against the plain one: all three outputs equal
    on integer-valued pixels (ties included); else ``sad`` within
    ``SAD_TOL`` and ``dy``/``dx`` equal except at near-ties, where the
    chosen candidate's plain SAD is within ``SAD_TOL`` of the plain
    minimum.  Returns the number of near-ties."""
    (dy, dx, sad), (rdy, rdx, rsad) = got, want
    check(dy.dtype == dx.dtype == torch.int32 and sad.dtype == torch.float32
          and dy.shape == dx.shape == sad.shape == (cur.shape[0],),
          f"{what}: outputs {dy.dtype} {dx.dtype} {sad.dtype} "
          f"{tuple(sad.shape)}")
    if exact:
        check(torch.equal(dy, rdy) and torch.equal(dx, rdx)
              and torch.equal(sad, rsad),
              f"{what}: not equal to the plain version on integer pixels "
              f"({int(((dy != rdy) | (dx != rdx)).sum())} choices differ, "
              f"max |sad diff| {float((sad - rsad).abs().max())})")
        return 0
    rel = float(((sad - rsad).abs() / rsad.abs().clamp_min(1e-30)).max())
    check(rel <= SAD_TOL, f"{what}: sad differs by rtol {rel} > {SAD_TOL}")
    off = (dy != rdy) | (dx != rdx)
    if bool(off.any()):
        chosen = _sad_at(cur, win, dy, dx)
        near = (chosen - rsad).abs() <= SAD_TOL * rsad.abs()
        check(bool(near[off].all()),
              f"{what}: {int((off & ~near).sum())} choices differ beyond a "
              f"near-tie")
    return int(off.sum())


def _sad_inputs(rng, n: int, b: int, r: int, integer: bool):
    w = b + 2 * r
    if integer:
        cur = rng.integers(0, 256, (n, b, b)).astype(np.float32)
        win = rng.integers(0, 256, (n, w, w)).astype(np.float32)
        win[0] = 77.0  # a constant window: every candidate ties at (0, 0)
    else:
        cur = (rng.standard_normal((n, b, b)) * 25).astype(np.float32)
        win = (rng.standard_normal((n, w, w)) * 25).astype(np.float32)
    return torch.from_numpy(cur).to(DEVICE), torch.from_numpy(win).to(DEVICE)


def sad_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.sad import sad_search, sad_search_ref

    rng = np.random.default_rng(seed + 4)
    near_ties = worst = 0
    for b, r in SAD_SWEEP_BR:
        for n in SAD_SWEEP_N:
            for integer in (True, False):
                cur, win = _sad_inputs(rng, n, b, r, integer)
                got = sad_search(cur, win)
                want = sad_search_ref(cur, win)
                torch.cuda.synchronize()
                what = (f"sad_search b={b} r={r} N={n} "
                        f"{'integer' if integer else 'float'}")
                near_ties += check_sad(got, want, cur, win, what, integer)
                if integer:
                    check((int(got[0][0]), int(got[1][0])) == (0, 0),
                          f"{what}: a constant window chose "
                          f"({int(got[0][0])}, {int(got[1][0])})")
                worst = max(worst, float((got[2] - want[2]).abs().max()))
    print(f"sad_search sweep: (b, r) in {SAD_SWEEP_BR}, N in {SAD_SWEEP_N}, "
          f"integer and float pixels: integer exact (ties and a constant "
          f"window included), float near_ties={near_ties} "
          f"max_abs_err={worst:.3g}", flush=True)
    timed = {}
    for h, w, b, r in MOTION_PAIRS:
        n = (h // b) * (w // b)
        cur, win = _sad_inputs(rng, n, b, r, False)
        k_ms = cuda_ms(lambda: sad_search(cur, win), iters=20)
        r_ms = cuda_ms(lambda: sad_search_ref(cur, win), iters=3, warmup=1)
        b_ms, b_by = sad_bound_ms(n, b, r)
        one, one_w = cur[:1].contiguous(), win[:1].contiguous()
        h_us = host_us(lambda: sad_search(one, one_w))
        print(f"sad_search N={n} b={b} r={r} ({h}p pair): kernel_ms="
              f"{k_ms:.6f} plain_ms={r_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
              f"share_of_bound={b_ms / k_ms:.3f} wrapper host_us={h_us:.3f}",
              flush=True)
        timed[(h, w)] = dict(ms=k_ms, plain_ms=r_ms, bound_ms=b_ms,
                             bound_by=b_by, host_us=h_us,
                             label=f"sad_search N={n} b={b} r={r}")
    return dict(timed[MOTION_PAIRS[0][:2]], max_abs_err=worst,
                library_ms=None,
                by_shape={t["label"]: t["ms"] for t in timed.values()})


def motion_path_phase(seed: int, frames) -> int:
    """Motion search between consecutive frames of the synthetic video at
    1080p (b=8) and 720p (b=16): ``frame_motion_blocks`` on the host, one
    pinned H2D copy, one launch, one D2H copy per pair, held against the
    plain version; then the planted shift on a real frame.  Returns the
    launches of the two pairs."""
    from repro_torch.data.video_gen import generate, sparse_spec
    from repro_torch.kernels.sad import (frame_motion_blocks, sad_search_op,
                                         sad_search_ref)

    pairs = {(H, W): frames[:2]}
    f720, _ = generate(sparse_spec(seed=seed, height=720, width=1280,
                                   n_frames=2))
    pairs[(720, 1280)] = f720

    def run(cur, ref, b, r):
        t0 = time.perf_counter()
        blocks, windows = frame_motion_blocks(cur, ref, b=b, r=r)
        t1 = time.perf_counter()
        host = (torch.from_numpy(blocks).pin_memory(),
                torch.from_numpy(windows).pin_memory())
        dev = [x.to(DEVICE, non_blocking=True) for x in host]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = sad_search_op(*dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        res = [x.cpu() for x in out]
        t4 = time.perf_counter()
        times = dict(blocks_s=t1 - t0, h2d_s=t2 - t1, kernel_s=t3 - t2,
                     d2h_s=t4 - t3)
        return dev, out, res, times

    reset_counts()
    runs = {}
    for h, w, b, r in MOTION_PAIRS:
        f = pairs[(h, w)]
        runs[(h, w)] = run(f[1], f[0], b, r)
    launches = read_counts()
    check(launches["sad_search"] == len(MOTION_PAIRS)
          and sum(launches.values()) == len(MOTION_PAIRS),
          f"the motion path launched {launches}, want one sad_search per "
          f"pair")
    near_ties = 0
    for h, w, b, r in MOTION_PAIRS:
        dev, out, res, times = runs[(h, w)]
        what = f"motion {h}p b={b} r={r}"
        near_ties += check_sad(out, sad_search_ref(*dev), *dev, what, False)
        check(all(torch.equal(a, c.cpu()) for a, c in zip(res, out)),
              f"{what}: D2H copy differs")
        f8 = np.clip(np.round(pairs[(h, w)]), 0, 255).astype(np.float32)
        dev8, out8, _, _ = run(f8[1], f8[0], b, r)
        check_sad(out8, sad_search_ref(*dev8), *dev8, f"{what} 8-bit", True)
        moved = float(((out[0] != r) | (out[1] != r)).float().mean())
        print(f"{what}: N={dev[0].shape[0]} " +
              " ".join(f"{k}={v:.6f}" for k, v in times.items()) +
              f" moved_share={moved:.4f} mean_sad={float(out[2].mean()):.3f}"
              f" (8-bit frames: exact)", flush=True)
    # the planted shift of tests/test_kernels.py on a real 8-bit frame:
    # cur[y, x] == ref[y - 3, x + 2], so inner blocks match at (r-3, r+2)
    h, w, b, r = MOTION_PAIRS[0]
    ref = np.clip(np.round(frames[0]), 0, 255).astype(np.float32)
    cur = np.roll(ref, shift=PLANT, axis=(0, 1))
    dev = [torch.from_numpy(x).to(DEVICE)
           for x in frame_motion_blocks(cur, ref, b=b, r=r)]
    out = sad_search_op(*dev)
    check_sad(out, sad_search_ref(*dev), *dev, "planted shift", True)
    dy, dx, sad = (x.cpu().numpy() for x in out)
    nby, nbx = h // b, w // b
    inner = np.zeros((nby, nbx), bool)
    inner[1:-1, 1:-1] = True
    inner = inner.ravel()
    hit = (dy == r - PLANT[0]) & (dx == r - PLANT[1])
    check(bool((sad[inner] == 0).all()),
          f"planted shift: {int((sad[inner] != 0).sum())} inner blocks have "
          f"a nonzero SAD")
    share = float(hit[inner].mean())
    print(f"motion planted shift {PLANT} on a {h}p frame: inner blocks "
          f"{int(inner.sum())}, found at (r-3, r+2): {share:.6f} (the rest "
          f"tie at SAD 0 with an earlier candidate); near_ties in the "
          f"pairs={near_ties}", flush=True)
    check(share >= 0.5, f"planted shift found in only {share} of blocks")
    return launches["sad_search"]


def _serve_config(**kw):
    from repro_torch.configs.base import get_config, make_serve_config

    cfg = make_serve_config(get_config(ARCH), model_axis=1)
    return dataclasses.replace(cfg, **kw)


def _plain_prefill_attention():
    """A test-only patch: the attention module's kernel entry replaced by
    the plain version, so the same model prefills without the kernel."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models import attention

    return mock.patch.object(
        attention, "flash_attention_op",
        lambda q, k, v, causal=True: attention_ref(q, k, v, causal=causal))


def _device_split(what: str, fn, *, bwd: bool = False) -> dict:
    """Device time of ``fn()``, by kind, from the profiler (None where it
    recorded no device time); prints the largest other kernels.  With
    ``bwd`` the attention backward's kernels are a kind of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"flash_attention_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    if bwd:
        split["flash_attention_bwd_ms"] = 0.0
    others = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.device_time_total / 1e3
        name = evt.key.lower()
        if bwd and "attention_bwd" in name:
            split["flash_attention_bwd_ms"] += ms
        elif "flash_attention" in name:
            split["flash_attention_ms"] += ms
        # cuBLAS's Hopper kernels are named nvjet_*, older ones *gemm*
        elif any(t in name for t in ("nvjet", "gemm", "gemv", "matmul",
                                     "xmma", "cutlass", "cublas")):
            split["matmul_ms"] += ms
        else:
            split["other_ms"] += ms
            others[evt.key[:60]] = others.get(evt.key[:60], 0.0) + ms
    if sum(split.values()) == 0.0:
        return {k: None for k in split}
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    print(f"{what}, largest other kernels: " +
          "; ".join(f"{k} {v:.6f} ms" for k, v in top), flush=True)
    return split


def _generate(model, cfg, prompts) -> tuple:
    """(prefill logits, greedy tokens [B, SERVE_NEW], TTFT s, decode tok/s,
    generate wall s, launches of ``greedy_generate``): one timed prefill
    and decode loop, then ``greedy_generate`` itself with the counts set
    to 0 just before it and read just after."""
    from repro_torch.serve import (greedy_generate, make_decode_step,
                                   make_prefill_step)

    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    decode = make_decode_step(cfg, device=DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(model, {"tokens": prompts})
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        t0 = time.perf_counter()
        for i in range(SERVE_NEW - 1):
            step, caches = decode(model, caches, {"tokens": tok},
                                  SERVE_S + i)
            tok = torch.argmax(step[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        tok_s = SERVE_B * (SERVE_NEW - 1) / (time.perf_counter() - t0)
    reset_counts()
    t0 = time.perf_counter()
    out = greedy_generate(model, cfg, prompts, max_new=SERVE_NEW,
                          device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return logits, out, ttft, tok_s, wall, read_counts()


def serve_phase(seed: int) -> dict:
    """The LM serving slice at full width; returns the launches of the
    main path's prefill."""
    from repro_torch.models import init_model
    from repro_torch.serve import (ContinuousBatcher, greedy_generate,
                                   make_decode_step, make_prefill_step)

    rng = np.random.default_rng(seed + 3)
    cfg = _serve_config()
    model = init_model(cfg, seed, device=DEVICE)
    check(cfg.n_layers == 30 and cfg.d_model == 576
          and model.embed.table.dtype == torch.bfloat16,
          f"serving {cfg.name} with {cfg.n_layers} layers")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve {cfg.name}: {n_params} parameters (param_count "
          f"{cfg.param_count()}), {cfg.param_dtype} weights, "
          f"{cfg.compute_dtype} compute, kv_repeat={cfg.kv_repeat}",
          flush=True)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (SERVE_B, SERVE_S))).to(DEVICE)
    greedy_generate(model, cfg, prompts[:, :64], max_new=2, device=DEVICE)

    # (a) the main path through the kernel
    logits, out, ttft, tok_s, wall, launches = _generate(model, cfg, prompts)
    check(launches["flash_attention"] == cfg.n_layers,
          f"greedy_generate launched flash_attention "
          f"{launches['flash_attention']} times, want {cfg.n_layers} (one "
          f"prefill)")
    check(tuple(out.shape) == (SERVE_B, SERVE_NEW)
          and bool(torch.isfinite(logits).all()),
          f"greedy_generate gave {tuple(out.shape)}")
    print(f"serve (a) B={SERVE_B} S={SERVE_S} new={SERVE_NEW}: "
          f"ttft_s={ttft:.6f} decode_tok_per_s={tok_s:.3f} "
          f"greedy_generate_wall_s={wall:.6f} launches={launches}",
          flush=True)

    # (b) the same model with the plain prefill attention
    with _plain_prefill_attention():
        p_logits, p_out, p_ttft, _, _, p_launches = _generate(model, cfg,
                                                              prompts)
    check(p_launches["flash_attention"] == 0,
          "the plain prefill launched the kernel")
    err = float((logits - p_logits).abs().max())
    agree = float((out == p_out).float().mean())
    print(f"serve (b) bf16 kernel vs plain prefill attention: logits "
          f"max_abs_err={err:.6g} greedy_agreement={agree:.6f} "
          f"plain ttft_s={p_ttft:.6f}", flush=True)
    check(err <= LOGITS_ATOL[torch.bfloat16],
          f"bf16 prefill logits differ by {err}")

    # (c) f32 at 4 layers
    cfg32 = _serve_config(param_dtype="float32", compute_dtype="float32",
                          n_layers=F32_LAYERS)
    m32 = init_model(cfg32, seed, device=DEVICE)
    l32, o32, _, _, _, k32 = _generate(m32, cfg32, prompts)
    check(k32["flash_attention"] == F32_LAYERS,
          f"f32 greedy_generate launched {k32}")
    with _plain_prefill_attention():
        pl32, po32, _, _, _, _ = _generate(m32, cfg32, prompts)
    err32 = float((l32 - pl32).abs().max())
    agree32 = float((o32 == po32).float().mean())
    print(f"serve (c) f32, {F32_LAYERS} layers, kernel vs plain: logits "
          f"max_abs_err={err32:.6g} greedy_agreement={agree32:.6f}",
          flush=True)
    check(err32 <= LOGITS_ATOL[torch.float32] and agree32 >= AGREE_F32,
          f"f32 serving: logits differ by {err32}, agreement {agree32}")
    del m32

    # (d) the continuous batcher
    batcher = ContinuousBatcher(cfg, model, slots=BATCH_SLOTS,
                                max_len=BATCH_MAX_LEN, device=DEVICE)
    want = []
    for _ in range(BATCH_REQUESTS):
        n = int(rng.integers(BATCH_PROMPT[0], BATCH_PROMPT[1] + 1))
        new = int(rng.integers(BATCH_NEW[0], BATCH_NEW[1] + 1))
        batcher.submit(rng.integers(0, cfg.vocab, n), max_new=new)
        want.append(new)
    waves = -(-BATCH_REQUESTS // BATCH_SLOTS)
    reset_counts()
    stats = batcher.run_until_drained()
    torch.cuda.synchronize()
    b_launches = read_counts()["flash_attention"]
    check(stats["requests"] == BATCH_REQUESTS
          and sorted(len(r.out_tokens) for r in batcher.finished)
          == sorted(want),
          f"batcher finished {stats['requests']} requests")
    check(b_launches == waves * cfg.n_layers,
          f"batcher launched flash_attention {b_launches} times for "
          f"{waves} waves, want {waves * cfg.n_layers}")
    print(f"serve (d) ContinuousBatcher(slots={BATCH_SLOTS}, max_len="
          f"{BATCH_MAX_LEN}), {BATCH_REQUESTS} requests: {json.dumps(stats)} "
          f"launches={b_launches}", flush=True)

    # (e) where a prefill's and a decode step's device time goes
    prefill = make_prefill_step(cfg, SERVE_S + SERVE_NEW, device=DEVICE)
    decode = make_decode_step(cfg, device=DEVICE)
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(model,
                                                   {"tokens": prompts})

    def run_decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        decode(model, state["caches"], {"tokens": tok}, SERVE_S)

    for what, fn, wall in (("prefill", run_prefill, ttft),
                           ("decode step", run_decode, SERVE_B / tok_s)):
        split = _device_split(f"serve (e) {what}", fn)
        busy = (None if split["other_ms"] is None
                else sum(split.values()) / 1e3 / wall)
        print(f"serve (e) one B={SERVE_B} S={SERVE_S} {what}, device time "
              f"(torch.profiler): " +
              " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                       for k, v in split.items()) +
              f"; device busy share of its wall time "
              f"({wall:.6f} s, unprofiled): "
              f"{'not measured' if busy is None else f'{busy:.4f}'}",
              flush=True)
    return launches


# ---------------------------------------------------------------- training
def flash_bwd_bound_ms(shape, dtype, causal: bool) -> tuple[float, str]:
    """Least time for one attention backward: q, k, v, o, dO and the f32
    lse read and dq, dk, dv written once over the HBM rate, against the
    five products the gradient needs (recomputed scores, dP, dv, dk, dq; 2
    FLOPs per multiply-add over the live (query, key) pairs) over the
    card's peak for the type."""
    b, h, kv, s, d = shape
    elt = torch.finfo(dtype).bits // 8
    n_bytes = (b * s * d * (4 * h + 4 * kv) * elt) + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 5 * 2 * b * h * d * pairs
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_row_err(got: torch.Tensor, want: torch.Tensor,
                floor: float) -> float:
    """The largest |got - want| of one gradient, each element over the
    largest |want| of its row (over D), that scale taken at least
    ``floor``."""
    w = want.float()
    row = w.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
    return float(((got.float() - w).abs() / row).max())


def flash_bwd_kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(seed + 4)
    worst, at_main = 0.0, None
    for shape, dtype in ((BWD_MAIN, torch.bfloat16),
                         (BWD_F32, torch.float32)):
        q, k, v = _qkv(rng, *shape, dtype)
        dout = _qkv(rng, *shape, dtype)[0]
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for causal in (True, False):
            # the main path's chain: the forward kernel's o and lse into
            # the backward kernel, each held against its plain version
            o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            got = flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
            o_ref = attention_ref(q, k, v, causal=causal)
            lse_ref = attention_lse_ref(q, k, causal=causal)
            torch.cuda.synchronize()
            o_err = float((o.float() - o_ref.float()).abs().max())
            lse_err = float((lse - lse_ref).abs().max())
            check(o_err <= FLASH_TOL[dtype],
                  f"flash_attention o vs plain {shape} {dtype} causal="
                  f"{causal}: max |diff| {o_err} > {FLASH_TOL[dtype]}")
            check(lse_err <= LSE_ATOL,
                  f"flash_attention lse vs plain {shape} {dtype} causal="
                  f"{causal}: max |diff| {lse_err} > {LSE_ATOL}")
            want = attention_bwd_ref(q, k, v, o_ref, dout, lse_ref,
                                     causal=causal)
            floor = BWD_FLOOR * max(float(w.float().abs().max())
                                    for w in want)
            rel = {}
            for gname, a, w in zip(("dq", "dk", "dv"), got, want):
                rel[gname] = bwd_row_err(a, w, floor)
                check(rel[gname] <= BWD_TOL[dtype],
                      f"flash_attention_bwd {gname} vs plain {shape} "
                      f"{dtype} causal={causal}: {rel[gname]} of its row's "
                      f"largest > {BWD_TOL[dtype]}")
                worst = max(worst, float((a.float() - w.float()).abs().max()))
            print(f"flash_attention_bwd {shape} {name} causal={causal} vs "
                  f"plain: o {o_err:.3g}, lse {lse_err:.3g}, "
                  + ", ".join(f"{g} {r:.3g}" for g, r in rel.items())
                  + " of the row's largest", flush=True)
            del got, want, o_ref, lse_ref
        o, lse = flash_attention(q, k, v, return_lse=True)
        k_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, dout, lse),
                       iters=5)
        r_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, o, dout, lse),
                       iters=2, warmup=1)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        ref_out = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
        l_ms = cuda_ms(lambda: torch.autograd.grad(
            ref_out, (qg, kg, vg), dout, retain_graph=True), iters=5)
        b_ms, b_by = flash_bwd_bound_ms(shape, dtype, True)
        print(f"flash_attention_bwd {shape} {name} causal: kernel_ms="
              f"{k_ms:.6f} plain_ms={r_ms:.6f} sdpa_backward_ms={l_ms:.6f} "
              f"bound_ms={b_ms:.6f} ({b_by}) share_of_bound="
              f"{b_ms / k_ms:.3f}", flush=True)
        if shape == BWD_MAIN:
            at_main = dict(ms=k_ms, plain_ms=r_ms, library_ms=l_ms,
                           bound_ms=b_ms, bound_by=b_by)
        del qg, kg, vg, ref_out
    q, k, v = _qkv(rng, 1, 9, 3, 16, 64, torch.bfloat16)
    o, lse = flash_attention(q, k, v, return_lse=True)
    at_main.update(max_abs_err=worst, host_us=host_us(
        lambda: flash_attention_bwd(q, k, v, o, q, lse)))
    print(f"flash_attention_bwd max_abs_err={worst:.3g} wrapper host cost: "
          f"{at_main['host_us']:.3f} us/call", flush=True)
    return at_main


def _grads(model, cfg, batch) -> tuple:
    """(loss, {name: gradient}) of ``loss_fn`` on ``batch``."""
    from repro_torch.models import loss_fn

    params = dict(model.named_parameters())
    model.requires_grad_(True)
    loss, _ = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    model.requires_grad_(False)
    return loss.detach(), dict(zip(params, grads))


def _f32_step_card_vs_cpu(seed: int) -> None:
    """(c): the same f32 step on the card and on the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)

    layers, b, s = TRAIN_F32
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                              param_dtype="float32",
                              compute_dtype="float32")
    cpu = init_model(cfg, seed, device="cpu")
    card = init_model(cfg, seed, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed + 5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    reset_counts()
    loss_d, g_d = _grads(card, cfg,
                         {k: v.to(DEVICE) for k, v in batch.items()})
    torch.cuda.synchronize()
    counts = read_counts()
    loss_h, g_h = _grads(cpu, cfg, batch)
    check(counts["flash_attention_bwd"] == layers,
          f"f32 card step launched {counts}")
    rel = abs(float(loss_d) - float(loss_h)) / abs(float(loss_h))
    check(rel <= 1e-5, f"f32 loss card {float(loss_d)} cpu {float(loss_h)}")
    worst = 0.0
    for name, gh in g_h.items():
        diff = float((g_d[name].cpu() - gh).abs().max())
        ratio = diff / max(float(gh.abs().max()), 1e-30)
        check(ratio <= GRAD_RTOL, f"f32 gradient {name}: max |diff| {diff},"
                                  f" {ratio} of the leaf's largest")
        worst = max(worst, ratio)
    # the update from the same gradients: the card's against the CPU's
    opt_cfg = AdamWConfig(lr=1e-3)
    p_d, p_h = dict(card.named_parameters()), dict(cpu.named_parameters())
    adamw_update(g_d, init_opt_state(p_d), p_d, opt_cfg)
    adamw_update({n: g_d[n].cpu() for n in g_d}, init_opt_state(p_h), p_h,
                 opt_cfg)
    upd = max(float((p_d[n].cpu() - p_h[n]).abs().max()
                    / p_h[n].abs().max()) for n in p_h)
    check(upd <= 1e-6, f"f32 AdamW update card vs cpu: {upd} of a leaf's "
                       f"largest")
    print(f"train (c) f32, {layers} layers at full width, B={b} S={s}, card "
          f"vs cpu: loss {float(loss_d):.7f} / {float(loss_h):.7f} (rel "
          f"{rel:.3g}); worst gradient diff {worst:.3g} of its leaf's "
          f"largest; params after AdamW from the same gradients "
          f"{upd:.3g} of their leaf's largest; "
          f"launches {counts}", flush=True)


def _recovery(seed: int) -> None:
    """(d): the recoverable loop through a simulated fault."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import synthetic_token_batches
    from repro_torch.train.elastic import LoopConfig, recoverable_train_loop
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    layers, b, s = TRAIN_F32
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                              param_dtype="bfloat16")
    model = init_model(cfg, seed, device=DEVICE)
    opt = init_opt_state(dict(model.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=6))
    saved = {}

    def step_fn(state, batch):
        model, opt = state
        model, opt, metrics = step(model, opt, batch)
        return (model, opt), metrics

    def on_metrics(n, m):
        if n == 2:
            saved["embed"] = model.embed.table.detach().clone()

    faults = {"armed": True}

    def fault_hook(n):
        if n == 3 and faults["armed"]:
            faults["armed"] = False
            saved["at_fault"] = model.embed.table.detach().clone()
            raise RuntimeError("simulated node failure")

    restored = {}
    with tempfile.TemporaryDirectory() as ckdir:
        ckpt = CheckpointManager(ckdir, keep=2)
        real_restore = ckpt.restore

        def restore(target, **kw):
            out = real_restore(target, **kw)
            restored["embed"] = model.embed.table.detach().clone()
            return out

        ckpt.restore = restore
        t0 = time.perf_counter()
        (model, opt), steps, restarts = recoverable_train_loop(
            (model, opt), synthetic_token_batches(cfg.vocab, b, s, seed=seed),
            step_fn, ckpt=ckpt,
            cfg=LoopConfig(total_steps=6, checkpoint_every=2),
            fault_hook=fault_hook, on_metrics=on_metrics)
        wall = time.perf_counter() - t0
        kept = ckpt.list_steps()
    torch.cuda.synchronize()
    check(restarts == 1 and steps == 6 and kept == [4, 6],
          f"recoverable loop: restarts={restarts} steps={steps} kept={kept}")
    check(torch.equal(restored["embed"], saved["embed"]),
          "the restore did not bring back the step-2 parameters")
    print(f"train (d) recoverable_train_loop, {layers} layers at full width:"
          f" a fault at step 3, restored from step 2 bit for bit, "
          f"restarts={restarts} steps={steps} checkpoints kept {kept} "
          f"wall_s={wall:.3f}", flush=True)


def _launcher(seed: int) -> None:
    """(e): ``python -m repro_torch.launch.train --device cuda``, then
    ``--resume``."""
    with tempfile.TemporaryDirectory() as ckdir:
        outs = []
        for steps, extra in ((3, []), (5, ["--resume"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train",
                 "--device", DEVICE, "--steps", str(steps),
                 "--checkpoint-dir", ckdir, "--checkpoint-every", "3",
                 *extra], env=_port_env(), capture_output=True, text=True,
                timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"launch.train exited {proc.returncode}: {proc.stderr}")
            outs.append(proc.stdout)
            print(f"train (e) launch.train --steps {steps} {extra}: exit 0 "
                  f"in {wall:.3f} s: " +
                  " | ".join(proc.stdout.strip().splitlines()), flush=True)
    check(f"device={DEVICE}" in outs[0] and "done: 3 steps" in outs[0],
          f"launch.train: {outs[0]}")
    check("resumed from step 3" in outs[1] and "done: 5 steps" in outs[1],
          f"launch.train --resume: {outs[1]}")


def train_phase(seed: int) -> int:
    """The training slice at full width; returns the backward kernel's
    launches over the main path's run."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model
    from repro_torch.train.data import synthetic_token_batches
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config(ARCH), param_dtype="bfloat16")
    model = init_model(cfg, seed, device=DEVICE)
    opt = init_opt_state(dict(model.named_parameters()))
    check(cfg.n_layers == 30 and cfg.d_model == 576 and cfg.vocab == 49152
          and "master" in opt, f"training {cfg.name} at {cfg.n_layers} "
                               f"layers")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=TRAIN_STEPS))
    data = synthetic_token_batches(cfg.vocab, TRAIN_B, TRAIN_S, seed=seed)
    batches = [next(data) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the main path: TRAIN_STEPS steps through both attention kernels
    losses, times, per_step = [], [], []
    reset_counts()
    for batch in batches[:TRAIN_STEPS]:
        before = read_counts()
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        times.append(time.perf_counter() - t0)
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in
                         ("flash_attention", "flash_attention_bwd")})
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(all(c == {"flash_attention": 2 * cfg.n_layers,
                    "flash_attention_bwd": cfg.n_layers} for c in per_step),
          f"per-step launches {per_step}")
    check(launches["flash_attention_bwd"] == TRAIN_STEPS * cfg.n_layers,
          f"train launches {launches}")
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0], f"loss did not fall: first {losses[0]}, mean "
                             f"of the last 5 {last5}")
    med = float(np.median(times[1:]))
    print(f"train (a) {cfg.name} B={TRAIN_B} S={TRAIN_S}, bf16 params + "
          f"f32 master, remat, {TRAIN_STEPS} steps: first step "
          f"{times[0]:.6f} s, median step {med:.6f} s, tokens_per_s="
          f"{TRAIN_B * TRAIN_S / med:.1f}, peak_memory_bytes={peak}, "
          f"launches per step {per_step[-1]}, total {launches}; loss first "
          f"{losses[0]:.6f}, mean of the last 5 {last5:.6f}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)

    # (b) where one step's device time goes
    split = _device_split("train (b) one step",
                          lambda: step(model, opt, batches[TRAIN_STEPS]),
                          bwd=True)
    busy = (None if split["other_ms"] is None
            else sum(split.values()) / 1e3 / med)
    print("train (b) one step, device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()) +
          f"; device busy share of the median step ({med:.6f} s, "
          f"unprofiled): {'not measured' if busy is None else f'{busy:.4f}'}",
          flush=True)
    del model, opt, batches
    torch.cuda.empty_cache()

    _f32_step_card_vs_cpu(seed)
    _recovery(seed)
    _launcher(seed)
    return launches["flash_attention_bwd"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data.video_gen import generate, sparse_spec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"build_s={build_all():.3f}", flush=True)

    numbers = {"decode_gop_blocks": decode_kernel_phase(args.seed)}
    numbers.update(encode_kernel_phase(args.seed))
    numbers["flash_attention"] = flash_kernel_phase(args.seed)
    numbers["sad_search"] = sad_kernel_phase(args.seed)

    t0 = time.perf_counter()
    frames, dets = generate(sparse_spec(seed=args.seed, height=H, width=W,
                                        n_frames=N_FRAMES))
    print(f"generate_s={time.perf_counter() - t0:.3f}", flush=True)
    motion = motion_path_phase(args.seed, frames)
    store, ingest = ingest_phase(frames, dets)
    scan, oracle = scan_phase(store)
    video_server_phase(store, oracle)
    store.close()
    del store, oracle
    cli_server_phase(args.seed)
    cluster_phase(args.seed)
    for mode in ("inline", "background"):
        retile_phase(frames, dets, mode)
    del frames
    calibration_phase()
    serve = serve_phase(args.seed)
    numbers["flash_attention_bwd"] = flash_bwd_kernel_phase(args.seed)
    train = train_phase(args.seed)

    now = {"decode_gop_blocks F=16 M=32768":
           numbers["decode_gop_blocks"]["ms"],
           f"flash_attention {FLASH_MAIN} bf16 causal":
           numbers["flash_attention"]["ms"],
           f"flash_attention {FLASH_LONG} bf16 causal":
           numbers["flash_attention"]["long_ms"],
           f"dct_quant N={H * W // 64} inter": numbers["dct_quant"]["ms"],
           f"idct_dequant N={H * W // 64} inter":
           numbers["idct_dequant"]["ms"],
           **numbers["sad_search"]["by_shape"]}
    print("redesigned kernels, this run against the time before the "
          "redesign (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W): " +
          "; ".join(f"{k}: {now[k]:.6f} ms, before {v:.6f} ms "
                    f"({v / now[k]:.2f}x)"
                    for k, v in BEFORE_REDESIGN.items()), flush=True)

    launches = {"decode_gop_blocks": scan["decode_gop_blocks"],
                "dct_quant": ingest["dct_quant"],
                "idct_dequant": ingest["idct_dequant"],
                "flash_attention": serve["flash_attention"],
                "sad_search": motion, "flash_attention_bwd": train}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", **KERNELS[name],
        "launches": launches[name],
        "max_abs_err": numbers[name]["max_abs_err"],
        "ms": numbers[name]["ms"], "plain_ms": numbers[name]["plain_ms"],
        "bound_ms": numbers[name]["bound_ms"],
        "bound_by": numbers[name]["bound_by"],
        "library_ms": numbers[name].get("library_ms")}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
