"""The port's video and LM examples and its model smoke
(``examples/{quickstart,edge_tiling,serve_lm,continuous_batching}_torch.py``,
``scripts/smoke_models_torch.py``) as ``--device cpu`` subprocesses, each
held to the contract it prints; and every new entry point refusing to
start without a CUDA device when none is named.  The background tuner's
workload example is in ``test_torch_examples_workload.py`` and the
server and cluster drills in ``test_torch_smokes.py``, to spread the
time."""
import pytest
import torch

from _torch_entry import EXAMPLES, SCRIPTS, load, run


def test_quickstart_on_the_cpu():
    out = run("quickstart_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    text = out.stdout
    assert "ingested untiled on cpu" in text
    assert "reopened ['traffic'] from manifest; scan bit-identical: True" \
        in text
    for line in ("remote scan over", "cluster of 3 nodes", "killed n",
                 "zero-copy serving", "numpy oracle backend"):
        (hit,) = [l for l in text.splitlines() if l.startswith(line)]
        assert ": True" in hit, hit
    assert "contracts: 11 of 11 hold" in text


def test_edge_tiling_on_the_cpu():
    out = run("edge_tiling_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("(8 GOPs pre-tiled)") == 4
    assert "catalog now holds 5 videos" in out.stdout
    assert "contracts: 5 of 5 hold" in out.stdout


def test_serve_lm_on_the_cpu():
    out = run("serve_lm_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "generated 8x48 tokens" in out.stdout
    assert "logits finite: True" in out.stdout


def test_continuous_batching_on_the_cpu():
    out = run("continuous_batching_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "'requests': 10" in out.stdout
    assert "logits finite: True" in out.stdout


def test_smoke_models_on_the_cpu():
    from repro_torch.configs.base import ARCH_IDS

    out = run("smoke_models_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert sorted(l.split()[1] for l in lines if l.startswith("OK ")) == \
        sorted(ARCH_IDS)
    assert lines[-1] == "ALL OK"


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal without a CUDA device")
@pytest.mark.parametrize("name", EXAMPLES + SCRIPTS)
def test_refuses_to_start_without_a_card(name, capsys):
    assert load(name).main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
