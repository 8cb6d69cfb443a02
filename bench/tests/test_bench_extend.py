"""A later change adds a configuration, a mix, a per-layer metric and a
cell as new files and entries in BENCHMARK.json, and edits no file the
benchmark has: the harness, in a copy of the benchmark, finds them all."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, PREFILL

PROBE = r"""
import json, sys
sys.path[:0] = ["bench", sys.argv[1]]
import harness
cell = harness.find_cell("deepseek-v2-lite-16b-copy.short_burst")
assert cell.config["name"] == "deepseek-v2-lite-16b-copy"
assert cell.traffic["prompt_max"] == 1024
assert [m["name"] for m in cell.per_layer] == ["waves_per_s.burst"]
assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                "prefill_tokens_per_s"]
out = harness.RunOutput(attempted=4, failed=0,
                        end_to_end={"setup_s": 1.5,
                                    "prefill_tokens_per_s": 100.0},
                        ctx={"window_s": 2.0, "counters": {"waves": 5}},
                        numbers={"token_gap": 0.0}, memory_peak_bytes=1,
                        trace={"busy_s": 1.0, "window_s": 2.0,
                               "kernel_s": {}, "device_ops": [],
                               "idle_gaps": []})
line = harness.result_line(cell, out, trace=True, device_kind="x", count=1)
print(json.dumps(line["metrics"]))
"""


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_cell_mix_and_metric_from_new_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "bench")
    b = tmp_path / "bench"
    conf = json.loads((b / "configs/deepseek-v2-lite-16b.json").read_text())
    conf["name"] = "deepseek-v2-lite-16b-copy"
    (b / "configs/deepseek-v2-lite-16b-copy.json").write_text(
        json.dumps(conf))
    mix = json.loads((b / "traffic/long_prompt.json").read_text())
    mix["prompt_max"] = 1024
    (b / "traffic/short_burst.json").write_text(json.dumps(mix))
    (b / "metrics/waves_per_s.burst.py").write_text(
        "def read(ctx):\n"
        "    return ctx['counters']['waves'] / ctx['window_s']\n")
    cell = "deepseek-v2-lite-16b-copy.short_burst"
    (b / f"limits/{cell}.json").write_text(json.dumps({"token_gap": 1.0}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1],
                                 name="deepseek-v2-lite-16b-copy",
                                 file="bench/configs/"
                                      "deepseek-v2-lite-16b-copy.json"))
    bench["workloads"].append({"name": cell,
                               "config": "deepseek-v2-lite-16b-copy",
                               "traffic": "short_burst", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "waves_per_s.burst",
                               "unit": "waves/s", "better": "higher",
                               "source": "program_counter",
                               "layer": "serving batcher",
                               "moves": "prefill_tokens_per_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    src = str(BENCH.parent / "src")
    proc = subprocess.run([sys.executable, "-c", PROBE, src],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "waves_per_s.burst": {"value": 2.5, "unit": "waves/s"}}
    after = _digest(tmp_path / "bench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert PREFILL in {w["name"] for w in bench["workloads"]}
