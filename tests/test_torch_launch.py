"""The port's LM launchers and training example as subprocesses on the CPU:
``python -m repro_torch.launch.train --device cpu --reduced`` for 3 steps,
then ``--resume`` to 5 from its checkpoint, and the token-only families
(MoE, SSM, hybrid, MLA) for 2 steps, then ``--resume`` to 3; ``python -m
repro_torch.launch.serve`` (smollm, the SSM and hybrid families, and
DeepSeek's MLA with and without ``--kv-quant``); ``--mesh`` on one rank
(1x1, the same tokens as without it, ``--kv-shard seq`` too) and on two
ranks of a gloo world, and what it still refuses (a mesh that is not the
world's size, a family past dense and MoE on a mesh past 1x1);
``--device cuda`` without a card (exit 1, "no CUDA device");
``examples/train_video_lm_torch.py`` through its simulated fault;
``examples/video_analytics_torch.py`` (the store feeding the reduced VLM)
on the CPU, and without a card; the VLM through the serving launcher."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args, timeout=300):
    """``python *args`` from the repo root, ``src`` on the path, at most
    two OpenMP threads unless the environment says otherwise: the suite
    runs in several workers at once, and a CPU run whose thread teams
    outnumber the cores many times over can stall for minutes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "2")
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


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "deepseek-v2-lite-16b"])
def test_train_then_resume_the_token_only_families(arch, tmp_path):
    """The launcher feeds tokens only, as the reference's does, so it
    trains every family but the encoder-decoder and the VLM: 2 steps with
    a checkpoint, then a resume to 3, each logging a finite loss."""
    args = (*TRAIN, "--arch", arch, "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2")
    first = _run(*args, "--steps", "2")
    assert first.returncode == 0, first.stderr
    assert f"arch={arch}-smoke" in first.stdout
    assert "done: 2 steps, restarts=0" in first.stdout
    assert (tmp_path / "LATEST").read_text() == "step_000000002"
    second = _run(*args, "--steps", "3", "--resume")
    assert second.returncode == 0, second.stderr
    assert "resumed from step 2" in second.stdout
    assert "done: 3 steps, restarts=0" in second.stdout
    for out, step in ((first.stdout, 2), (second.stdout, 3)):
        line = next(x for x in out.splitlines()
                    if x.startswith(f"step {step:5d} loss"))
        assert all(np.isfinite(float(x)) for x in line.split()[3::2]), line


def test_serve_runs():
    out = _run("-m", "repro_torch.launch.serve", "--device", "cpu",
               "--reduced", "--batch", "2", "--prompt-len", "8",
               "--max-new", "4")
    assert out.returncode == 0, out.stderr
    assert "serving smollm-135m-smoke" in out.stdout
    assert "prefill 2x8 in" in out.stdout and "decode 4 steps" in out.stdout


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "falcon-mamba-7b"])
def test_serve_runs_the_ssm_families(arch):
    out = _run("-m", "repro_torch.launch.serve", "--arch", arch, "--device",
               "cpu", "--reduced", "--batch", "2", "--prompt-len", "8",
               "--max-new", "4")
    assert out.returncode == 0, out.stderr
    assert f"serving {arch}-smoke" in out.stdout
    assert "prefill 2x8 in" in out.stdout and "decode 4 steps" in out.stdout


def test_serve_runs_the_vlm():
    """internvl2-26b serves text prompts through the launcher, as in the
    reference (its patch projector is built, and not fed)."""
    out = _run("-m", "repro_torch.launch.serve", "--arch", "internvl2-26b",
               "--device", "cpu", "--reduced", "--batch", "2",
               "--prompt-len", "8", "--max-new", "4")
    assert out.returncode == 0, out.stderr
    assert "serving internvl2-26b-smoke" in out.stdout
    assert "prefill 2x8 in" in out.stdout and "decode 4 steps" in out.stdout


def test_analytics_example_runs_on_the_cpu():
    """``examples/video_analytics_torch.py --device cpu``: the store's
    ingest and scans feed three batches of crops to the reduced VLM, whose
    logits are finite, then the tuner drains."""
    out = _run("examples/video_analytics_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "analytics backbone: internvl2-26b-smoke" in out.stdout
    for i in range(3):
        assert f"batch {i}: crops (4, 16, 16)" in out.stdout
    assert out.stdout.count("finite=True") == 3
    assert "layouts after analytics queries:" in out.stdout


@pytest.mark.parametrize("quant", [(), ("--kv-quant",)],
                         ids=["float", "int8"])
def test_serve_runs_mla(quant):
    out = _run("-m", "repro_torch.launch.serve", "--arch",
               "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
               "--batch", "2", "--prompt-len", "8", "--max-new", "4", *quant)
    assert out.returncode == 0, out.stderr
    assert (f"serving deepseek-v2-lite-16b-smoke: kv_repeat=1 "
            f"quant={bool(quant)} shard=heads") in out.stdout
    assert "prefill 2x8 in" in out.stdout and "decode 4 steps" in out.stdout


@pytest.mark.parametrize("args,names", [
    (("-m", "repro_torch.launch.train", "--mesh", "2,2"),
     "mesh (2, 2) holds 4 ranks; the world has 1"),
    (("-m", "repro_torch.launch.serve", "--mesh", "2,2"),
     "mesh (2, 2) holds 4 ranks; the world has 1"),
    (("-m", "repro_torch.launch.train", "--arch", "zamba2-1.2b", "--mesh",
      "2,1"), "queue 1 item 9"),
])
def test_refused_flags(args, names):
    out = _run(*args, "--device", "cpu")
    assert out.returncode == 2
    assert names in out.stderr


def _tokens_line(out) -> str:
    assert out.returncode == 0, out.stderr
    return [line for line in out.stdout.splitlines()
            if line.startswith("tokens ")][-1]


SERVE = ("-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--max-new", "4")


@pytest.mark.parametrize("arch,extra", [
    ("smollm-135m", ("--kv-shard", "seq")), ("qwen3-moe-30b-a3b", ())])
def test_serve_on_a_one_rank_mesh(arch, extra):
    plain = _run(*SERVE, "--arch", arch)
    out = _run(*SERVE, "--arch", arch, "--mesh", "1,1", *extra)
    assert "mesh {'data': 1, 'model': 1} on cpu" in out.stdout
    assert _tokens_line(out) == _tokens_line(plain)


def test_train_on_a_one_rank_mesh(tmp_path):
    out = _run(*TRAIN, "--steps", "3", "--mesh", "1,1", "--checkpoint-dir",
               str(tmp_path), "--checkpoint-every", "3")
    assert out.returncode == 0, out.stderr
    assert "policy dp_train" in out.stdout
    assert "done: 3 steps, restarts=0" in out.stdout
    assert (tmp_path / "LATEST").read_text() == "step_000000003"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(n: int, *args, timeout=240):
    """``python *args`` as the n ranks of one world (the environment
    ``torchrun`` gives its workers, on a free localhost port); their
    results by rank."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n))
    procs = [subprocess.Popen([sys.executable, *args], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**env, "RANK": str(r),
                                   "LOCAL_RANK": str(r)})
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [subprocess.CompletedProcess(p.args, p.returncode, o, e)
            for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize("mesh,kw", [("2,1", ()), ("1,2", ("--kv-shard",
                                                           "seq"))],
                         ids=["data", "model_seq"])
def test_launchers_on_two_ranks(mesh, kw, tmp_path):
    train = _ranks(2, *TRAIN, "--steps", "2", "--mesh", mesh,
                   "--checkpoint-dir", str(tmp_path), "--checkpoint-every",
                   "2", "--arch", "qwen3-moe-30b-a3b")
    assert [r.returncode for r in train] == [0, 0], train[0].stderr + \
        train[1].stderr
    assert "done: 2 steps" in train[0].stdout and not train[1].stdout
    assert (tmp_path / "LATEST").read_text() == "step_000000002"
    serve = _ranks(2, *SERVE, "--mesh", mesh, *kw)
    assert [r.returncode for r in serve] == [0, 0], serve[0].stderr + \
        serve[1].stderr
    assert _tokens_line(serve[0]).startswith("tokens 2x5 sha256=")


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.serve",
                                    "examples/video_analytics_torch.py"])
def test_cuda_without_a_card_exits_1(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    if module.endswith(".py"):
        out = _run(module, "--device", "cuda")
    else:
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
