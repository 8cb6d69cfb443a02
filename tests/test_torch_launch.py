"""The port's LM launchers and training example as subprocesses on the CPU:
``python -m repro_torch.launch.train --device cpu --reduced`` for 3 steps,
then ``--resume`` to 5 from its checkpoint; ``python -m
repro_torch.launch.serve``; the flags the port refuses (``--mesh``,
``--kv-quant``, ``--kv-shard seq``); ``--device cuda`` without a card
(exit 1, "no CUDA device"); ``examples/train_video_lm_torch.py`` through
its simulated fault."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


TRAIN = ("-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--batch", "2", "--seq", "32")


def test_train_then_resume(tmp_path):
    first = _run(*TRAIN, "--steps", "3", "--checkpoint-dir", str(tmp_path),
                 "--checkpoint-every", "3")
    assert first.returncode == 0, first.stderr
    assert "device=cpu" in first.stdout
    assert "done: 3 steps, restarts=0" in first.stdout
    assert (tmp_path / "LATEST").read_text() == "step_000000003"
    manifest = json.loads(
        (tmp_path / "step_000000003" / "manifest.json").read_text())
    assert manifest["extra"] == {"step": 3}
    # (model, opt): the model's bf16 params and the f32 master copy
    assert manifest["leaves"]["0/embed.table"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["1/master/embed.table"]["dtype"] == "float32"
    second = _run(*TRAIN, "--steps", "5", "--checkpoint-dir", str(tmp_path),
                  "--checkpoint-every", "3", "--resume")
    assert second.returncode == 0, second.stderr
    assert "resumed from step 3" in second.stdout
    assert "done: 5 steps, restarts=0" in second.stdout
    assert "step     5 loss" in second.stdout


def test_serve_runs():
    out = _run("-m", "repro_torch.launch.serve", "--device", "cpu",
               "--reduced", "--batch", "2", "--prompt-len", "8",
               "--max-new", "4")
    assert out.returncode == 0, out.stderr
    assert "serving smollm-135m-smoke" in out.stdout
    assert "prefill 2x8 in" in out.stdout and "decode 4 steps" in out.stdout


@pytest.mark.parametrize("args,names", [
    (("-m", "repro_torch.launch.train", "--mesh", "2,2"), "queue 1 item 9"),
    (("-m", "repro_torch.launch.serve", "--mesh", "2,2"), "queue 1 item 9"),
    (("-m", "repro_torch.launch.serve", "--kv-quant"), "queue 1 item 7"),
    (("-m", "repro_torch.launch.serve", "--kv-shard", "seq"),
     "queue 1 item 7"),
])
def test_refused_flags(args, names):
    out = _run(*args, "--device", "cpu")
    assert out.returncode == 2
    assert names in out.stderr and "not ported" in out.stderr


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.serve"])
def test_cuda_without_a_card_exits_1(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _run("-m", module, "--reduced", "--device", "cuda")
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr


def test_training_example_recovers_and_learns():
    out = _run("examples/train_video_lm_torch.py", "--device", "cpu",
               "--steps", "40", "--fail-at", "20", "--batch", "4",
               "--seq", "64")
    assert out.returncode == 0, out.stderr
    assert "restarts=1" in out.stdout
    assert "simulated node failure" in out.stderr
