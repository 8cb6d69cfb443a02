"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package ``repro``, a CPU scan runs without
either in ``sys.modules``, and a store with no device named decodes on CUDA
or refuses to start."""
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
    assert files
    return files + [ROOT / "chip_smoke.py"]


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
    code = textwrap.dedent("""
        import sys
        from repro_torch.core import DecodeConfig, NoTilingPolicy, VideoStore
        from repro_torch.data.video_gen import generate, sparse_spec
        frames, dets = generate(sparse_spec(seed=1, n_frames=16, height=96,
                                            width=160))
        store = VideoStore(decode=DecodeConfig(device="cpu"))
        store.ingest("v", frames, detections=dets, policy=NoTilingPolicy())
        res = store.scan("v").labels("car").frames(0, 16).execute()
        store.close()
        assert res.regions and res.stats.tiles_decoded > 0
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
