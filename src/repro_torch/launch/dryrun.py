"""Dry run of the port over the table of architectures x input shapes, on
one H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --arch all|<id>[,<id>...] --shape all|<name>[,<name>...] \\
        [--force] [--out DIR]

Counterpart of the reference's ``launch/dryrun.py``.  For every (arch x
shape) cell it builds the port's real step (``make_train_step``,
``make_prefill_step`` or ``make_decode_step``; a train step one
microbatch of it, see ``_train``) and runs it once on tensors of the
``meta`` device under ``analytic_cost.StepCount``, so
nothing is allocated or computed: the walk gives the step's FLOPs (the
reference's chunk rule for the attention kernels) and the peak of its
live temporaries.  The row records those, the exact bytes of the step's
arguments, the reference's HBM-traffic model, the roofline terms against
the card's published peaks (``launch/mesh.py``) and whether the step fits
the card's 80 GB, and is appended to ``<out>/1xh100.jsonl`` (default
``results/dryrun_torch/``).  A cell already ``ok`` or ``skipped`` there
is not run again unless ``--force`` is given.  ``--mesh multi`` exits 1:
walking a step over a multi-card mesh is what is left of ROADMAP queue 1
item 9 (``distributed/`` runs sharded steps, but the dry run walks one
card).

The reference's adjustments are kept: training params in bf16 unless
``REPRO_TORCH_VARIANT`` holds ``f32w``; the prefill's chunks widened to S
// 16 and S // 32; the serving config of a one-device model axis.  The
reference's ``plainkv`` variant chooses the cache's placement over a mesh,
which has no meaning for a walk of one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time
import traceback
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig,
                                      ShapeSpec, get_config, get_shape,
                                      make_serve_config)
from repro_torch.launch import analytic_cost as ac
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (HBM_PER_CHIP, MESH_REFUSED,
                                     make_production_mesh)
from repro_torch.models import zoo
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import AdamWConfig, make_train_step
from repro_torch.utils.tree import tree_size_bytes

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results" /
               "dryrun_torch")
MESH_NAME = "1xh100"
SKIP_REASON = "full-attention arch; long_500k needs sub-quadratic context"

#: bytes of the card the residual carry of a training step may take before
#: the batch is split into microbatches: the reference leaves 4 GB of a 16
#: GB TPU v5e chip to it; this is the same quarter of the H100's 80 GB
CARRY_BUDGET = HBM_PER_CHIP / 4


# --------------------------------------------------------------------------
# Memory-driven microbatch choice (the reference's napkin model)
# --------------------------------------------------------------------------
def choose_microbatches(cfg: ArchConfig, shape: ShapeSpec, mesh) -> int:
    if shape.kind != "train":
        return 1
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    tp = mesh.shape.get("model", 1)
    b_loc = max(shape.global_batch // dp, 1)
    seq_fac = tp if shape.seq_len % tp == 0 else 1
    # residual carry per layer, sequence-sharded; 2 bytes bf16
    carry = b_loc * shape.seq_len * cfg.d_model * 2 / seq_fac
    total_layers = cfg.n_layers + cfg.enc_layers
    need = carry * total_layers / CARRY_BUDGET
    micro = 1
    while micro < need and micro < b_loc:
        micro *= 2
    return micro


# --------------------------------------------------------------------------
# Cell runners
# --------------------------------------------------------------------------
class Walk(NamedTuple):
    """A cell's step, the arguments it is walked on, the bytes the real
    step's arguments hold, the reference's tiling of its attention calls
    (``analytic_cost.tiling_of`` its config), the factor of the walk's
    FLOPs, the bytes the real step holds beside the walk's temporaries,
    and the row's own keys."""
    step: Callable
    args: tuple
    held_bytes: float
    tiling: tuple
    times: int = 1
    extra_bytes: float = 0.0
    row: dict = {}


def argument_bytes(args) -> float:
    """Exact bytes of a step's arguments: a model's parameters (an
    ``nn.Module`` is its ``state_dict``), the optimizer state, the batch
    and the caches."""
    total = 0
    for a in args:
        if isinstance(a, torch.nn.Module):
            a = a.state_dict()
        total += tree_size_bytes(a)
    return float(total)


def _train(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Walk:
    """The train step walks one microbatch: the step at ``microbatches=1``
    on B / micro rows.  Every microbatch of the real step is the same work
    on the same shapes, so the row's FLOPs are ``micro`` times the walk's,
    as the reference's walk multiplies its scan's body by the length; its
    arguments hold the whole batch, and beside its temporaries the real
    step holds f32 gradient accumulators when micro > 1
    (``train_step.py``).  Walking each microbatch would take hours for the
    largest cells."""
    if "f32w" not in os.environ.get("REPRO_TORCH_VARIANT", ""):
        # bf16 params + an f32 master copy in the optimizer state
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    micro = choose_microbatches(cfg, shape, mesh)
    model = zoo.init_model(cfg, device="meta")
    opt = init_opt_state(dict(model.named_parameters()))
    one = dataclasses.replace(shape,
                              global_batch=shape.global_batch // micro)
    accumulators = 4.0 * sum(p.numel() for p in model.parameters())
    return Walk(make_train_step(cfg, AdamWConfig()),
                (model, opt, zoo.input_specs(cfg, one)),
                argument_bytes((model, opt, zoo.input_specs(cfg, shape))),
                ac.tiling_of(cfg), times=micro,
                extra_bytes=accumulators if micro > 1 else 0.0,
                row={"microbatches": micro, "cache_bytes": 0.0,
                     "policy": "one_device"})


def prefill_config(cfg: ArchConfig, shape: ShapeSpec, mesh) -> ArchConfig:
    """The serving config of a prefill cell: bf16 params, ``kv_repeat``
    for the mesh's model axis, and the chunks widened to S // 16 and S //
    32 (which change only the attention's charge, not what is computed)."""
    scfg = make_serve_config(cfg, mesh.shape.get("model", 1))
    return dataclasses.replace(
        scfg, q_chunk=max(scfg.q_chunk, shape.seq_len // 16),
        kv_chunk=max(scfg.kv_chunk, shape.seq_len // 32))


def _prefill(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Walk:
    scfg = prefill_config(cfg, shape, mesh)
    model = zoo.init_model(scfg, device="meta")
    caches = zoo.init_cache_specs(scfg, shape.global_batch, shape.seq_len)
    args = (model, zoo.input_specs(scfg, shape))
    return Walk(make_prefill_step(scfg, shape.seq_len, device="meta"), args,
                argument_bytes(args), ac.tiling_of(scfg),
                row={"kv_repeat": scfg.kv_repeat,
                     "cache_bytes": float(tree_size_bytes(caches))})


def _decode(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Walk:
    scfg = make_serve_config(cfg, mesh.shape.get("model", 1))
    model = zoo.init_model(scfg, device="meta")
    caches = zoo.init_cache(scfg, shape.global_batch, shape.seq_len,
                            device="meta")
    args = (model, caches, zoo.input_specs(scfg, shape), shape.seq_len - 1)
    return Walk(make_decode_step(scfg, device="meta"), args,
                argument_bytes(args), ac.tiling_of(scfg),
                row={"kv_repeat": scfg.kv_repeat,
                     "cache_bytes": float(tree_size_bytes(caches))})


def _memory_dict(walk: Walk, count: ac.StepCount) -> dict:
    """Per-device footprint: the exact bytes of the arguments, and as
    temporaries the peak of the live tensors the walk allocated (outputs,
    gradients and new caches included; :class:`analytic_cost.StepCount`)
    plus what the real step holds beside them (``Walk.extra_bytes``);
    ``total_device_bytes`` is their sum."""
    temp = float(count.peak_bytes) + walk.extra_bytes
    return {"argument_size_in_bytes": walk.held_bytes,
            "temp_size_in_bytes": temp,
            "total_device_bytes": walk.held_bytes + temp}


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    row: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": int(mesh.size)}
    if not cfg.supports_shape(shape):
        row["status"] = "skipped"
        row["reason"] = SKIP_REASON
        return row
    t0 = time.time()
    try:
        build = {"train": _train, "prefill": _prefill}.get(shape.kind,
                                                            _decode)
        walk = build(cfg, shape, mesh)
        row.update(walk.row)
        with ac.StepCount(walk.tiling) as count:
            walk.step(*walk.args)
        row["flops_global"] = count.flops * walk.times
        row["attention_flops"] = count.attention_flops * walk.times
        row["walk_s"] = round(time.time() - t0, 1)
        row["memory"] = _memory_dict(walk, count)
        coll = rl.no_collectives()
        row["collectives"] = coll

        bytes_model = ac.hbm_bytes_per_chip(
            cfg, shape, mesh, mode=shape.kind,
            microbatches=row.get("microbatches", 1),
            cache_bytes_total=row.get("cache_bytes", 0.0))
        row["hbm_model"] = bytes_model
        terms = rl.derive_terms(
            arch=arch, shape=shape_name, mesh_name=mesh_name,
            chips=row["chips"], flops_global=row["flops_global"],
            hbm_bytes_chip=bytes_model["total"], coll=coll,
            model_flops=rl.model_flops_estimate(cfg, shape),
            bytes_per_device=row["memory"]["total_device_bytes"])
        row["roofline"] = terms.as_dict()
        row["fits_hbm"] = bool(row["memory"]["total_device_bytes"]
                               <= HBM_PER_CHIP)
        row["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - record the failure in the table
        row["status"] = "error"
        row["error"] = f"{type(e).__name__}: {e}"
        row["traceback"] = traceback.format_exc()[-4000:]
    return row


def cell_line(row: dict) -> str:
    """One line of a cell's result, as the CLI prints it."""
    if row["status"] == "skipped":
        return f"  skipped: {row.get('reason')}"
    if row["status"] == "error":
        return f"  ERROR: {row['error']}"
    r = row["roofline"]
    return (f"  ok: dominant={r['dominant']} compute={r['compute_s']:.3e}s "
            f"memory={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
            f"dev_bytes={row['memory']['total_device_bytes'] / 1e9:.2f}GB "
            f"fits={row['fits_hbm']} (walk {row.get('walk_s')}s)")


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--arch", default="all",
                    help="all, an arch id, or a comma-separated list")
    ap.add_argument("--shape", default="all",
                    help="all, a shape name, or a comma-separated list")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the rows (1xh100.jsonl)")
    args = ap.parse_args(argv)
    if args.mesh == "multi":
        print(f"dryrun: --mesh multi: {MESH_REFUSED}", file=sys.stderr)
        return 1
    mesh = make_production_mesh()
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{MESH_NAME}.jsonl"
    done = set()
    if out_path.exists() and not args.force:
        for line in out_path.read_text().splitlines():
            try:
                r = json.loads(line)
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"]))
            except json.JSONDecodeError:
                pass

    n_ok = n_err = 0
    for arch in archs:
        for shape_name in shapes:
            if (arch, shape_name) in done:
                print(f"[cached] {arch} x {shape_name}", flush=True)
                continue
            print(f"[run] {arch} x {shape_name} on {MESH_NAME}", flush=True)
            row = run_cell(arch, shape_name, mesh, MESH_NAME)
            with out_path.open("a") as f:
                row_out = {k: v for k, v in row.items() if k != "traceback"}
                f.write(json.dumps(row_out) + "\n")
            print(cell_line(row), flush=True)
            if row["status"] == "error":
                n_err += 1
                (out_dir / f"err_{arch}_{shape_name}_{MESH_NAME}.txt"
                 ).write_text(row.get("traceback", ""))
            else:
                n_ok += 1
    print(f"DONE ok={n_ok} err={n_err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
