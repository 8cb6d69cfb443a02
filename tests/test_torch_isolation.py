"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's entry points (``examples/*_torch.py``, ``scripts/*_torch.py``)
import neither JAX nor the reference package ``repro``, a CPU scan and a CPU
greedy generation run without either in ``sys.modules``, and a store with
no device named decodes on CUDA or refuses to start."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.core import DecodeConfig, VideoStore

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    entry = sorted((ROOT / "examples").glob("*_torch.py")) + sorted(
        (ROOT / "scripts").glob("*_torch.py"))
    assert files and len(entry) >= 9
    return files + [ROOT / "chip_smoke.py"] + entry


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_cpu_scan_loads_neither_jax_nor_reference():
    # an ingest, a retile (both encode through encode_tiles), scans and a
    # greedy generation
    code = textwrap.dedent("""
        import sys
        from repro_torch.core import (DecodeConfig, NoTilingPolicy,
                                      VideoStore, uniform_layout)
        from repro_torch.data.video_gen import generate, sparse_spec
        frames, dets = generate(sparse_spec(seed=1, n_frames=16, height=96,
                                            width=160))
        store = VideoStore(decode=DecodeConfig(device="cpu"))
        store.ingest("v", frames, detections=dets, policy=NoTilingPolicy())
        res = store.scan("v").labels("car").frames(0, 16).execute()
        assert res.regions and res.stats.tiles_decoded > 0
        assert store.retile("v", 0, uniform_layout(96, 160, 2, 2)) > 0
        assert store.epochs("v") == {0: 1}
        res = store.scan("v").labels("car").frames(0, 16).execute()
        store.close()
        assert res.regions and res.stats.tiles_decoded > 0
        # the model side: greedy decoding of a narrow smollm on the CPU
        import dataclasses
        import numpy as np
        from repro_torch.configs.base import get_config, make_serve_config
        from repro_torch.models import init_model
        from repro_torch.serve import greedy_generate
        cfg = make_serve_config(dataclasses.replace(
            get_config("smollm-135m"), n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=128, vocab=256), model_axis=1)
        model = init_model(cfg, 0, device="cpu")
        out = greedy_generate(model, cfg, np.ones((2, 9), np.int64),
                              max_new=3, device="cpu")
        assert tuple(out.shape) == (2, 3)
        for m in ("repro_torch.codec.encode", "repro_torch.kernels.dct.ops",
                  "repro_torch.kernels.idct.ops", "repro_torch.models.zoo",
                  "repro_torch.kernels.flash_attention.ops"):
            assert m in sys.modules, m
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_store_without_device_uses_cuda_or_raises():
    if torch.cuda.is_available():
        store = VideoStore()
        assert store.decode_config.device.startswith("cuda")
        assert store.decode_backend == "batched"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        VideoStore()
    with pytest.raises(RuntimeError, match="cuda"):
        VideoStore(decode=DecodeConfig(backend="numpy"))


def test_cpu_training_loads_neither_jax_nor_reference(tmp_path):
    # two train steps of a narrow smollm through the recoverable loop,
    # with a checkpoint saved and restored, in a fresh process
    code = textwrap.dedent(f"""
        import dataclasses, sys
        from repro_torch.configs.base import get_config
        from repro_torch.models import init_model
        from repro_torch.train.checkpoint import CheckpointManager
        from repro_torch.train.data import synthetic_token_batches
        from repro_torch.train.elastic import (LoopConfig,
                                               recoverable_train_loop)
        from repro_torch.train.optimizer import init_opt_state
        from repro_torch.train.train_step import make_train_step
        from repro_torch.utils import Timer, time_call
        cfg = dataclasses.replace(
            get_config("smollm-135m"), n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=128, vocab=256,
            param_dtype="bfloat16")
        model = init_model(cfg, 0, device="cpu")
        opt = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg)
        ckpt = CheckpointManager({str(tmp_path)!r})
        state, steps, restarts = recoverable_train_loop(
            (model, opt), synthetic_token_batches(256, 2, 16),
            lambda s, b: (lambda m, o, met: ((m, o), met))(*step(*s, b)),
            ckpt=ckpt, cfg=LoopConfig(total_steps=2, checkpoint_every=1))
        assert steps == 2 and restarts == 0
        assert ckpt.restore(state)[1] == {{"step": 2}}
        with Timer() as t:
            time_call(lambda: model.embed.table.sum(), iters=1)
        for m in ("repro_torch.train.train_step",
                  "repro_torch.train.checkpoint", "repro_torch.utils.tree",
                  "repro_torch.kernels.flash_attention.flash_attention_bwd"):
            assert m in sys.modules, m
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
