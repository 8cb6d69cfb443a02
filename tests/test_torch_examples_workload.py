"""The port's shifting-workload example
(``examples/incremental_workload_torch.py``, paper §5.3 W4) as a
``--device cpu`` subprocess: the background tuner charges no query and
converges to the inline layouts."""
from _torch_entry import run


def test_incremental_workload_on_the_cpu():
    out = run("incremental_workload_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "queries charged retile time: 0/60" in out.stdout
    assert "converged to the same layouts as inline: True" in out.stdout
    assert "contracts: 3 of 3 hold" in out.stdout
