"""Roofline terms of one step, and the HLO collective-bytes walker.

Counterpart of the reference's ``launch/roofline.py``, against the
published peaks of one H100 (``launch/mesh.py``):

    compute term    = FLOPs / (chips x peak bf16 FLOP/s)
    memory term     = HBM bytes / HBM bytes/s
    collective term = collective bytes / NVLink bytes/s

FLOPs come from the port's walk of what the step dispatches
(``analytic_cost.count_flops``), HBM bytes from the reference's napkin
model (``analytic_cost.hbm_bytes_per_chip``).  The port runs on one card
and issues no collective: its collective bytes are the zero dict
(:func:`no_collectives`).  ``collective_bytes_from_hlo`` and its helpers
are the reference's, verbatim: a parser of XLA's optimized HLO text that
multiplies while-loop bodies by their trip count, kept for the tests'
parity and for a dry run over a multi-card mesh, which is what is left of
ROADMAP queue 1 item 9.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass

import numpy as np

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# bytes-on-the-wire multiplier applied to the RESULT buffer size (ring model):
#   all-gather: result V -> each chip receives V*(n-1)/n ~ V
#   all-reduce: ~2V (reduce-scatter + all-gather phases)
#   reduce-scatter: result V (the scattered shard) -> wire ~ V*(n-1) global,
#     per-chip ~V*(n-1)/n*... we use operand-size when parseable, else V.
_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# computation headers have nested parens in the param list and no " = "
_COMP_HDR_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*->.*\{\s*$")
_WHILE_RE = re.compile(
    r"while\(.*?\)[^/]*?condition=%?([\w\.\-]+)[^/]*?body=%?([\w\.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_CALL_RE = re.compile(r"(?:fusion|call|custom-call)\(.*?(?:calls|to_apply)=%?([\w\.\-]+)")


def _shape_bytes(shape_str: str) -> int:
    m = _SHAPE_RE.match(shape_str)
    if not m:
        return 0
    dt, dims = m.group(1), m.group(2)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def _parse_computations(hlo_text: str):
    """Split optimized HLO text into named computations with their lines."""
    comps: dict[str, list[str]] = {}
    current = None
    for line in hlo_text.splitlines():
        m = _COMP_HDR_RE.match(line)
        if m and "{" in line and " = " not in line:
            current = m.group(1)
            comps[current] = []
            continue
        if current is not None:
            if line.strip() == "}":
                current = None
            else:
                comps[current].append(line)
    return comps


def _line_collective(line: str):
    """Returns (kind, result_bytes) if this line is a collective op."""
    for kind in _COLL_KINDS:
        token = f" {kind}(" if not kind.endswith("start") else None
        if f" {kind}(" in line or f" {kind}-start(" in line:
            # result shape is the first shape after '='
            eq = line.split("=", 1)
            if len(eq) != 2:
                return None
            m = _SHAPE_RE.search(eq[1])
            if not m:
                return None
            # tuple results: sum all shapes before the op name
            head = eq[1].split(kind)[0]
            total = sum(_shape_bytes(s.group(0)) for s in _SHAPE_RE.finditer(head))
            return kind, total
    return None


def collective_bytes_from_hlo(hlo_text: str) -> dict:
    """Computation-graph walk: multiply while bodies by their trip count.

    Trip counts are recovered heuristically from the loop condition's
    comparison constant (validated against known-scan-length fixtures).
    """
    comps = _parse_computations(hlo_text)

    local: dict[str, dict[str, float]] = {}
    calls: dict[str, list[tuple[str, float]]] = {}
    for name, lines in comps.items():
        local[name] = {}
        calls[name] = []
        for line in lines:
            got = _line_collective(line)
            if got:
                kind, b = got
                local[name][kind] = local[name].get(kind, 0.0) + b * _MULT[kind]
                continue
            wm = _WHILE_RE.search(line)
            if wm:
                cond, body = wm.group(1), wm.group(2)
                trip = 1.0
                for cl in comps.get(cond, []):
                    cm = _CONST_RE.search(cl)
                    if cm:
                        trip = max(trip, float(cm.group(1)))
                calls[name].append((body, trip))
                continue
            cm = _CALL_RE.search(line)
            if cm and cm.group(1) in comps:
                calls[name].append((cm.group(1), 1.0))

    memo: dict[str, dict[str, float]] = {}

    def total_of(comp: str, depth=0) -> dict[str, float]:
        if comp in memo:
            return memo[comp]
        if depth > 50:
            return {}
        out = dict(local.get(comp, {}))
        for child, mult in calls.get(comp, []):
            for k, v in total_of(child, depth + 1).items():
                out[k] = out.get(k, 0.0) + v * mult
        memo[comp] = out
        return out

    # entry computation: the one that is not called by anyone
    called = {c for lst in calls.values() for c, _ in lst}
    entries = [c for c in comps if c not in called]
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    for e in entries:
        for k, v in total_of(e).items():
            totals[k] = totals.get(k, 0.0) + v
    for name, lines in comps.items():
        for line in lines:
            got = _line_collective(line)
            if got:
                counts[got[0]] = counts.get(got[0], 0) + 1
    return {"bytes_by_kind": totals, "count_by_kind": counts,
            "total_bytes": float(sum(totals.values()))}


def no_collectives() -> dict:
    """The collectives of a step on one card: none, in the dict shape of
    :func:`collective_bytes_from_hlo`."""
    return {"bytes_by_kind": {}, "count_by_kind": {}, "total_bytes": 0.0}


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # global FLOPs for one step (dispatch walk)
    hlo_bytes: float          # per-chip HBM traffic (analytic model)
    collective_bytes: float   # per-chip wire bytes
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float        # 6*N*D (or 6*N_active*D)
    useful_ratio: float       # model_flops / hlo_flops
    bytes_per_device: float   # per-device memory footprint (meta walk)

    def as_dict(self):
        return asdict(self)


def derive_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                 flops_global: float, hbm_bytes_chip: float, coll: dict,
                 model_flops: float, bytes_per_device: float) -> RooflineTerms:
    compute_s = flops_global / (chips * PEAK_FLOPS_BF16)
    memory_s = hbm_bytes_chip / HBM_BW
    collective_s = coll["total_bytes"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / flops_global if flops_global else 0.0
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops_global, hlo_bytes=hbm_bytes_chip,
        collective_bytes=coll["total_bytes"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        bytes_per_device=bytes_per_device)


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode D = B tokens."""
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
