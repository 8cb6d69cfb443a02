"""The result line has the keys a run reports, with the compared numbers
last; a run without a card prints no result."""
import json
import os
import subprocess
import sys

from conftest import ANALYTICS, BENCH, PREFILL

import harness

CELLS = (ANALYTICS, PREFILL)


def _out(cell, numbers):
    return harness.RunOutput(
        attempted=10, failed=0,
        end_to_end={m["name"]: 1.25 for m in cell.end_to_end},
        ctx={"window_s": 2.0,
             "spans": {"scan": 0.5, "model": 1.5, "step": 2.0},
             "counters": {"crops": 8, "queries": 1, "pixels_decoded": 800.0,
                          "retile_s": 0.0,
                          "prompt_tokens": 30, "prefill_positions": 40,
                          "padded_positions": 10, "requests": 4,
                          "prefills": 1},
             "useful_flops": 1e12,
             "attention_calls": {(8, 48, 8, 1032, 128, 128): 48},
             "launches": {"flash_attention": 48, "decode_gop_blocks": 2}},
        numbers=numbers, memory_peak_bytes=123,
        trace={"busy_s": 1.5, "window_s": 2.0,
               "kernel_s": {"void flash_attention_mma_kernel<>": 0.01},
               "device_ops": [["gemm", 1.0]], "idle_gaps": [["scan", 0.4]]})


def test_result_line_keys():
    for name in CELLS:
        cell = harness.find_cell(name)
        good = {n: 0.0 for n in cell.limits}
        for trace in (False, True):
            line = harness.result_line(cell, _out(cell, good), trace=trace,
                                       device_kind="NVIDIA H100 80GB HBM3",
                                       count=1)
            assert list(line)[:5] == ["correct", "attempted", "failed",
                                      "metrics", "device"]
            assert list(line)[-1] == "checks"
            assert line["correct"] is True
            dev = line["device"]
            assert dev["platform"] == "gpu" and dev["count"] == 1
            assert isinstance(dev["memory_peak_bytes"], int)
            want = {m["name"] for m in (cell.per_layer if trace
                                        else cell.end_to_end)}
            if trace:
                assert dev["busy_s"] == 1.5 and dev["window_s"] == 2.0
                assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
                assert set(line["metrics"]) <= want
            else:
                assert set(line["metrics"]) == want
                assert "setup_s" in line["metrics"]
            json.dumps(line)


def test_a_number_over_its_limit_or_missing_fails():
    cell = harness.find_cell(PREFILL)
    over = {n: lim * 2 + 1 for n, lim in cell.limits.items()}
    assert not harness.result_line(cell, _out(cell, over), trace=False,
                                   device_kind="x", count=1)["correct"]
    assert not harness.judge({}, cell.limits)[0]


def test_every_metric_of_each_cell_has_a_reader():
    bench = harness.load_benchmark()
    for name in CELLS:
        cell = harness.find_cell(name)
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert [w["name"] for w in bench["workloads"]][0] == ANALYTICS


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", ANALYTICS,
         "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, env=env,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
