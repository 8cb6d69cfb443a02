"""No module of JAX or of the JAX package is loaded by the harness (top-level
names compared whole: ``repro_torch`` is the port), and the plain
references import nothing of the port."""
import json
import subprocess
import sys

from conftest import BENCH

HARNESS = r"""
import glob, json, os, sys
sys.path[:0] = ["bench", "src"]
import harness, sut, devtrace, modelspec, calibrate, run
import loops.analytics, loops.batcher, loops.common
import reference.lm, reference.codec
import frozen.flops, frozen.crops, frozen.video_gen
import repro_torch.serve, repro_torch.core, repro_torch.models.zoo
for f in glob.glob("bench/metrics/*.py"):
    harness.reader(os.path.basename(f)[:-3])
print(json.dumps(harness.forbidden_modules()))
"""

REFERENCE = r"""
import json, sys
sys.path[:0] = ["bench"]
import modelspec, reference.lm, reference.codec
import frozen.flops, frozen.crops, frozen.video_gen
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0].startswith("repro"))))
"""


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax_nor_the_jax_package():
    assert _run(HARNESS) == []


def test_references_import_nothing_of_the_port():
    assert _run(REFERENCE) == []
