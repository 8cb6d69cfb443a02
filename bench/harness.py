"""The benchmark's core: find a cell by name, run its loop, read its
metrics, judge its outputs and print the result.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in files of its own, found by the names in
``BENCHMARK.json``:

- ``configs/<config>.json`` (the ``file`` of its entry): the model and the
  deployment, in the published config's keys; ``arch`` names the program's
  registered architecture;
- ``traffic/<traffic>.json``: the mix's parameters; its ``loop`` names the
  module under ``loops/`` that generates that kind of traffic and drives
  the program with it;
- ``metrics/<metric>.py``, or ``metrics/<stem>.py`` for a metric named
  ``<stem>.<part>`` that has no file of its own (one reader serves every
  cell's ``mfu.*``): ``read(ctx) -> float | None``, the metric from what
  the loop recorded (None where it finds nothing to read);
- ``limits/<cell>.json``: each number the cell's comparison computes, with
  its limit.

So a later change adds a configuration, a mix, a metric or a cell as new
files and entries, and edits no file here.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass, field
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict                 # the configuration file's contents
    traffic: dict                # the mix's parameters
    end_to_end: list             # entries of BENCHMARK.json for this cell
    per_layer: list
    limits: dict                 # number -> limit


@dataclass
class RunOutput:
    """What a loop returns: counts, the end-to-end values it measured, the
    context the per-layer readers read, and the numbers it compared."""
    attempted: int
    failed: int
    end_to_end: dict
    ctx: dict
    numbers: dict                # number -> value (the program's reading)
    memory_peak_bytes: int
    trace: Optional[dict] = None
    control: dict = field(default_factory=dict)   # number -> control value


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None,
              root: pathlib.Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if ("workloads" in m and name in m["workloads"])
             or ("workloads" not in m and m["moves"] in names)]
    return Cell(name, w, config, traffic, e2e, layer, limits)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``, else ``metrics/<stem>.py``'s
    (the name before the first dot)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_loop(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False
             ) -> RunOutput:
    """The cell's loop (``loops/<traffic's loop>.py``): set-up from
    ``t_start`` (the process's start), the window, the comparison;
    ``control`` also computes the control's readings."""
    loop = importlib.import_module(f"loops.{cell.traffic['loop']}")
    return loop.run(cell, seed=seed, seconds=seconds, trace=trace,
                    device=device, t_start=t_start, control=control)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number the run could not compute (None) fails."""
    rows = [(n, numbers.get(n), lim) for n, lim in limits.items()]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def result_line(cell: Cell, out: RunOutput, *, trace: bool,
                device_kind: str, count: int) -> dict:
    correct, rows = judge(out.numbers, cell.limits)
    if trace:
        metrics = {}
        ctx = dict(out.ctx, device_trace=out.trace)
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.end_to_end}
    dev = {"platform": "gpu", "kind": device_kind, "count": count,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": bool(correct and out.failed == 0),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return line
