"""Dry run of the port over the table of architectures x input shapes, on
one H100 or over the reference's production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --mesh single|pod|multi \\
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
is not run again unless ``--force`` is given.

``--mesh pod`` (the reference's 16x16, rows in ``16_16.jsonl``) and
``--mesh multi`` (its 2x16x16, ``2_16_16.jsonl``) walk rank 0 of the
mesh in this process: a ``fake`` world of 256 or 512 ranks
(``launch/mesh.py::fake_world``), whose collectives move nothing.  The
model is placed by ``shard_model`` (``param_pspec`` of the policy
``choose_policy`` picks: FSDP + TP, or ``dp_train`` under ``dp_rules``),
the optimizer state of its local blocks beside it, the batch split by the
step's own ``batch_rows``, the caches placed by ``cache_pspec`` as
``meta`` blocks, under the reference's rules (``TRAIN_RULES`` and
``SERVE_RULES`` over a ``pod`` axis, the ``_1POD`` tables without one).
The row is rank 0's: ``flops_rank`` its walk (times the microbatches),
``flops_global`` that times the chips (what the mesh computes, replicated
work included), ``memory`` the local bytes of its arguments and its
walk's peak, ``collectives`` what it dispatched
(``StepCount.collective_ops``, the reference's kinds and ring
multipliers), the HBM model with the mesh.

The reference's adjustments are kept: training params in bf16 unless
``REPRO_TORCH_VARIANT`` holds ``f32w``; the prefill's chunks widened to S
// 16 and S // 32; the serving config of the mesh's model axis; over a
mesh, a decode cell's cache policy from ``choose_serve_cache_policy``
unless ``REPRO_TORCH_VARIANT`` holds ``plainkv``.
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.distributed import parallel
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import (SERVE_RULES, SERVE_RULES_1POD,
                                         TRAIN_RULES, TRAIN_RULES_1POD,
                                         dp_rules, use_sharding)
from repro_torch.launch import analytic_cost as ac
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (HBM_PER_CHIP, fake_world,
                                     make_production_mesh)
from repro_torch.models import zoo
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import AdamWConfig, make_train_step
from repro_torch.utils.tree import flatten_names

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results" /
               "dryrun_torch")
MESH_NAME = "1xh100"
#: ``--mesh`` -> (the rows' mesh name, the described mesh)
MESHES = {"single": (MESH_NAME, make_production_mesh()),
          "pod": ("16x16", make_production_mesh(pod=True)),
          "multi": ("2x16x16", make_production_mesh(multi_pod=True))}
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
    step's arguments hold on the rank, the reference's tiling of its
    attention calls (``analytic_cost.tiling_of`` its config), the factor
    of the walk's FLOPs, the bytes the real step holds beside the walk's
    temporaries, the row's own keys, and the rules the step runs under
    over a mesh (None on one card)."""
    step: Callable
    args: tuple
    held_bytes: float
    tiling: tuple
    times: int = 1
    extra_bytes: float = 0.0
    row: dict = {}
    rules: object = None


def _local_bytes(t) -> int:
    """Bytes one rank holds of ``t``: a ``DTensor``'s local block, a batch
    tensor's rows under an installed mesh (``parallel.batch_rows``)."""
    if parallel.is_dtensor(t):
        t = t.to_local()
    elif t.dim() and parallel.batch_groups():
        t = parallel.batch_rows(t)
    return t.numel() * t.element_size()


def argument_bytes(args) -> float:
    """Exact bytes of a step's arguments on one rank: a model's parameters
    (an ``nn.Module`` is its ``state_dict``), the optimizer state, the
    batch and the caches; under an installed mesh, the local blocks and
    this rank's rows of the batch."""
    total = 0
    for a in args:
        if isinstance(a, torch.nn.Module):
            a = a.state_dict()
        total += sum(_local_bytes(leaf) for _, leaf in flatten_names(a)
                     if isinstance(leaf, torch.Tensor))
    return float(total)


def _place(model, cfg: ArchConfig, mesh, kind: str):
    """``model`` placed over a built mesh by the cell's policy, and the
    policy and rules, as the reference's dry run chooses them:
    ``choose_policy``'s mode, ``dp_rules`` under ``dp_train``, else
    ``TRAIN_RULES`` / ``SERVE_RULES`` with a ``pod`` axis and the
    ``_1POD`` tables without one; on one card the model as it is, policy
    ``one_device``."""
    if mesh.device_mesh is None:
        return model, "one_device", None
    mode = shd.choose_policy(cfg, mesh, kind)
    pods = "pod" in mesh.axis_names
    if mode == "dp_train":
        rules = dp_rules(tuple(mesh.axis_names))
    elif kind == "train":
        rules = TRAIN_RULES if pods else TRAIN_RULES_1POD
    else:
        rules = SERVE_RULES if pods else SERVE_RULES_1POD
    return shd.shard_model(model, cfg, mesh, mode=mode), mode, rules


def _train(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Walk:
    """The train step walks one microbatch: the step at ``microbatches=1``
    on B / micro rows.  Every microbatch of the real step is the same work
    on the same shapes, so the row's FLOPs and collectives are ``micro``
    times the walk's, as the reference's walk multiplies its scan's body by
    the length (the optimizer's few small all-reduces, once a step, would
    be counted ``micro`` times too, but every train cell of the 16x16 and
    2x16x16 tables has one microbatch, and on one card there are none);
    its arguments hold the whole batch, and
    beside its temporaries the real step holds f32 gradient accumulators
    when micro > 1 (``train_step.py``).  Walking each microbatch would
    take hours for the largest cells."""
    if "f32w" not in os.environ.get("REPRO_TORCH_VARIANT", ""):
        # bf16 params + an f32 master copy in the optimizer state
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    micro = choose_microbatches(cfg, shape, mesh)
    model, policy, rules = _place(zoo.init_model(cfg, device="meta"), cfg,
                                  mesh, "train")
    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    one = dataclasses.replace(shape,
                              global_batch=shape.global_batch // micro)
    scope = (contextlib.nullcontext() if rules is None
             else use_sharding(rules, mesh))
    with scope:
        held = argument_bytes((model, opt, zoo.input_specs(cfg, shape)))
    accumulators = 4.0 * sum(parallel.local_tensor(p).numel()
                             for p in params.values())
    return Walk(make_train_step(cfg, AdamWConfig()),
                (model, opt, zoo.input_specs(cfg, one)), held,
                ac.tiling_of(cfg), times=micro,
                extra_bytes=accumulators if micro > 1 else 0.0,
                row={"microbatches": micro, "cache_bytes": 0.0,
                     "policy": policy}, rules=rules)


def prefill_config(cfg: ArchConfig, shape: ShapeSpec, mesh) -> ArchConfig:
    """The serving config of a prefill cell: bf16 params, ``kv_repeat``
    for the mesh's model axis, and the chunks widened to S // 16 and S //
    32 (which change only the attention's charge, not what is computed)."""
    scfg = make_serve_config(cfg, mesh.shape.get("model", 1))
    return dataclasses.replace(
        scfg, q_chunk=max(scfg.q_chunk, shape.seq_len // 16),
        kv_chunk=max(scfg.kv_chunk, shape.seq_len // 32))


def _cache_bytes(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Bytes of the whole decode cache of a serving cell (every rank's)."""
    caches = zoo.init_cache_specs(cfg, shape.global_batch, shape.seq_len)
    return float(sum(t.numel() * t.element_size()
                     for stack in caches.values() for t in stack.values()))


def _serve_walk(scfg: ArchConfig, shape: ShapeSpec, mesh, step, caches):
    """A serving cell's walk: the model placed over the mesh (``serve``),
    the batch, and the caches the step takes (none for a prefill, which
    makes its own as ``meta`` blocks)."""
    model, _, rules = _place(zoo.init_model(scfg, device="meta"), scfg,
                             mesh, "serve")
    args = (model,) + ((caches(),) if caches else ()) + (
        zoo.input_specs(scfg, shape),)
    if caches:
        args += (shape.seq_len - 1,)
    scope = (contextlib.nullcontext() if rules is None
             else use_sharding(rules, mesh))
    with scope:
        held = argument_bytes(args)
    return Walk(step, args, held, ac.tiling_of(scfg),
                row={"kv_repeat": scfg.kv_repeat,
                     "cache_bytes": _cache_bytes(scfg, shape)}, rules=rules)


def _prefill(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Walk:
    scfg = prefill_config(cfg, shape, mesh)
    return _serve_walk(scfg, shape, mesh, make_prefill_step(
        scfg, shape.seq_len, device="meta"), None)


def _serve_cache_config(scfg: ArchConfig, mesh) -> ArchConfig:
    """A decode cell's config over a built mesh: the cache policy of
    ``choose_serve_cache_policy``, unless ``REPRO_TORCH_VARIANT`` holds
    ``plainkv`` (the reference's variant); on one card ``scfg``."""
    if mesh.device_mesh is None or \
            "plainkv" in os.environ.get("REPRO_TORCH_VARIANT", ""):
        return scfg
    return dataclasses.replace(scfg,
                               **shd.choose_serve_cache_policy(scfg, mesh))


def _decode(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Walk:
    scfg = _serve_cache_config(
        make_serve_config(cfg, mesh.shape.get("model", 1)), mesh)
    B, S = shape.global_batch, shape.seq_len

    def caches():
        if mesh.device_mesh is None:
            return zoo.init_cache(scfg, B, S, device="meta")
        return shd.shard_cache(zoo.init_cache_specs(scfg, B, S), scfg, mesh,
                               device="meta")

    return _serve_walk(scfg, shape, mesh, make_decode_step(
        scfg, device="meta"), caches)


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
    """One row of the table: the cell walked on one card, or over a mesh
    of more than one rank as its rank 0 (in a :func:`fake_world` of the
    mesh's size, opened here unless ``mesh`` is built already)."""
    if mesh.size > 1 and mesh.device_mesh is None:
        with fake_world(mesh) as built:
            return run_cell(arch, shape_name, built, mesh_name)
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
        scope = (contextlib.nullcontext() if walk.rules is None
                 else use_sharding(walk.rules, mesh))
        with scope, ac.StepCount(walk.tiling) as count:
            walk.step(*walk.args)
        row["flops_rank"] = count.flops * walk.times
        row["flops_global"] = row["flops_rank"] * mesh.size
        row["attention_flops"] = (count.attention_flops * walk.times
                                  * mesh.size)
        row["walk_s"] = round(time.time() - t0, 1)
        row["memory"] = _memory_dict(walk, count)
        coll = rl.collective_bytes_from_ops(count.collective_ops,
                                            walk.times)
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


def rows_file(mesh_name: str) -> str:
    """The rows' file of a mesh: ``1xh100.jsonl``, and the reference's
    ``16_16.jsonl`` and ``2_16_16.jsonl``."""
    return (mesh_name if mesh_name == MESH_NAME
            else mesh_name.replace("x", "_")) + ".jsonl"


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
    ap.add_argument("--mesh", choices=list(MESHES), default="single",
                    help="single: one H100 (1xh100.jsonl); pod: 16x16 "
                         "(16_16.jsonl); multi: 2x16x16 (2_16_16.jsonl)")
    ap.add_argument("--arch", default="all",
                    help="all, an arch id, or a comma-separated list")
    ap.add_argument("--shape", default="all",
                    help="all, a shape name, or a comma-separated list")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the rows")
    args = ap.parse_args(argv)
    mesh_name, mesh = MESHES[args.mesh]
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / rows_file(mesh_name)
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
            print(f"[run] {arch} x {shape_name} on {mesh_name}", flush=True)
            row = run_cell(arch, shape_name, mesh, mesh_name)
            with out_path.open("a") as f:
                row_out = {k: v for k, v in row.items() if k != "traceback"}
                f.write(json.dumps(row_out) + "\n")
            print(cell_line(row), flush=True)
            if row["status"] == "error":
                n_err += 1
                (out_dir / f"err_{arch}_{shape_name}_{mesh_name}.txt"
                 ).write_text(row.get("traceback", ""))
            else:
                n_ok += 1
    print(f"DONE ok={n_ok} err={n_err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
