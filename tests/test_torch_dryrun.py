"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the
CPU: the mirror of ``tests/test_dryrun_cell.py`` (smollm-135m's
``train_4k`` cell walks, fits the card and counts more than 1e14 FLOPs,
with no collectives on one card), every cell of one arch of each family
and of the other architectures ``ok`` or ``skipped`` exactly where the
reference's ``supports_shape`` skips it (the SSM and hybrid families'
slower walks are in ``tests/test_torch_dryrun_ssm.py``), the CLI's rows,
resume and its rows over the reference's 2x16x16 mesh (the mesh walks
are in ``tests/test_torch_dryrun_mesh.py``), and the two ``_torch``
scripts over rows it wrote.  Every cell runs on ``meta`` tensors: nothing
is allocated."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs import base as jbase
from repro_torch.configs.base import ARCH_IDS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_PER_CHIP, make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "_torch_families", ROOT / "tests" / "_torch_families.py")
FAM = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FAM)

#: the families whose walks are quick (the SSM and hybrid scans loop over
#: their chunks: tests/test_torch_dryrun_ssm.py)
QUICK = ("dense", "moe", "mla", "encdec", "vlm")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def check_row(arch: str, shape: str, row: dict) -> None:
    """``ok`` with every key the reference's row has, or ``skipped``
    exactly where the reference's ``supports_shape`` says so."""
    supported = jbase.get_config(arch).supports_shape(jbase.get_shape(shape))
    if not supported:
        assert row["status"] == "skipped", row
        assert row["reason"] == dryrun.SKIP_REASON
        return
    assert row["status"] == "ok", row.get("traceback", row)
    assert row["flops_global"] > 0 and row["chips"] == 1
    assert row["collectives"]["total_bytes"] == 0.0
    r = row["roofline"]
    assert r["hlo_flops"] == row["flops_global"]
    assert r["dominant"] in ("compute", "memory")
    mem = row["memory"]
    assert mem["total_device_bytes"] == (mem["argument_size_in_bytes"] +
                                         mem["temp_size_in_bytes"]) > 0
    assert row["fits_hbm"] == (mem["total_device_bytes"] <= HBM_PER_CHIP)
    assert row["hbm_model"]["total"] > 0


def test_dryrun_cell_smollm_train_4k():
    row = dryrun.run_cell("smollm-135m", "train_4k", make_production_mesh(),
                          dryrun.MESH_NAME)
    assert row["status"] == "ok", row.get("error")
    assert row["fits_hbm"], row["memory"]
    assert row["roofline"]["hlo_flops"] > 1e14
    assert row["collectives"]["total_bytes"] == 0
    assert row["microbatches"] == 2


@pytest.mark.parametrize("family", QUICK)
def test_every_cell_of_a_family(family):
    arch = FAM.FAMILIES[family]
    mesh = make_production_mesh()
    for shape in SHAPES:
        check_row(arch, shape, dryrun.run_cell(arch, shape, mesh,
                                               dryrun.MESH_NAME))


@pytest.mark.parametrize("arch", sorted(set(ARCH_IDS) -
                                         set(FAM.FAMILIES.values())))
def test_every_cell_of_the_other_archs(arch):
    mesh = make_production_mesh()
    for shape in SHAPES:
        check_row(arch, shape, dryrun.run_cell(arch, shape, mesh,
                                               dryrun.MESH_NAME))


def test_smollm_prefill_32k_fits_and_decode_32k_does_not():
    mesh = make_production_mesh()
    prefill = dryrun.run_cell("smollm-135m", "prefill_32k", mesh, "1xh100")
    decode = dryrun.run_cell("smollm-135m", "decode_32k", mesh, "1xh100")
    # 30 layers x 32 x 32,768 positions x 3 KV heads x 64 x 2 x 2 bytes
    assert prefill["cache_bytes"] == 30 * 32 * 32768 * 3 * 64 * 2 * 2
    assert prefill["fits_hbm"]
    # the KV cache alone is 96.6 GB
    assert decode["cache_bytes"] == 4 * prefill["cache_bytes"] > 96e9
    assert not decode["fits_hbm"]


def test_cli_writes_and_resumes_rows(tmp_path, capsys):
    argv = ["--mesh", "single", "--arch", "smollm-135m", "--shape",
            "decode_32k", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    rows = (tmp_path / "1xh100.jsonl").read_text().splitlines()
    assert len(rows) == 1 and json.loads(rows[0])["status"] == "ok"
    assert dryrun.main(argv) == 0
    assert "[cached] smollm-135m x decode_32k" in capsys.readouterr().out
    assert len((tmp_path / "1xh100.jsonl").read_text().splitlines()) == 1
    assert dryrun.main(argv + ["--force"]) == 0
    assert len((tmp_path / "1xh100.jsonl").read_text().splitlines()) == 2


def test_multi_mesh_writes_rows(tmp_path):
    """``--mesh multi`` walks rank 0 of the reference's 2x16x16 in a fake
    world of 512 ranks and writes its rows to ``2_16_16.jsonl``, one a
    cell, skipped by the reference's rule."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--mesh", "multi", "--arch", "smollm-135m",
                          "--shape", "decode_32k,long_500k", "--out",
                          str(tmp_path)], capture_output=True, text=True,
                         env=_env(), timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = [json.loads(line) for line in
            (tmp_path / "2_16_16.jsonl").read_text().splitlines()]
    assert [(r["shape"], r["status"]) for r in rows] == [
        ("decode_32k", "ok"), ("long_500k", "skipped")]
    assert rows[0]["chips"] == 512 and rows[0]["mesh"] == "2x16x16"
    assert rows[0]["collectives"]["total_bytes"] > 0
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}


def test_scripts_run_on_cpu_rows(tmp_path):
    for shape in ("train_4k", "prefill_32k", "long_500k"):
        assert dryrun.main(["--arch", "smollm-135m", "--shape", shape,
                            "--out", str(tmp_path)]) == 0
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "render_roofline_md_torch.py"),
         "all", "--dir", str(tmp_path)], capture_output=True, text=True,
        env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "| smollm-135m | prefill_32k | compute |" in out.stdout
    assert "skipped (full attention @500k)" in out.stdout
    assert "projected roofline fraction" in out.stdout
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "hillclimb_torch.py"),
         "--arch", "smollm-135m", "--shape", "prefill_32k", "--out",
         str(tmp_path)], capture_output=True, text=True, env=_env(),
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "VARIANT baseline: dominant=compute" in out.stdout
    row = json.loads((tmp_path / "hillclimb_smollm-135m_prefill_32k.jsonl")
                     .read_text())
    assert row["collectives"]["total_bytes"] == 0.0
