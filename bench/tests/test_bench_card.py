"""Each cell end to end on the card, at a short window (skips without a
card): the run exits 0 with a correct result."""
import json
import subprocess
import sys

import pytest
from conftest import ANALYTICS, BENCH, PREFILL


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [ANALYTICS, PREFILL])
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "5", "--trace", "1"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
