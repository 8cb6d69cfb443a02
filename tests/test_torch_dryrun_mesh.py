"""The port's dry run over the reference's production meshes, on the CPU:
rank 0 of a ``fake`` world of 256 (16x16, ``--mesh pod``) or 512 ranks
(2x16x16, ``--mesh multi``) walked on ``meta`` tensors
(``launch/mesh.py::fake_world``, ``launch/dryrun.py``).

- The counterpart of ``tests/test_dryrun_cell.py`` (the reference's CI
  cell): smollm-135m x train_4k on 16x16 is ``ok``, fits the card, counts
  more than 1e14 FLOPs and moves collective bytes.
- ``flops_global`` (rank 0's walk times the chips) is at least the
  one-card walk's FLOPs of the same cell, and equal to them on a
  ``dp_train`` cell, where every rank computes its rows of the whole
  model.
- On 16x16 a rank of deepseek-v2-lite-16b's train step computes with
  its 1/16 of the vocabulary (the embedding's rows, ``lm_head``'s
  columns) and with its one of MLA's 16 heads (``wkv_b``'s columns,
  ``wo``'s rows), at the production widths.
- A serving cell on each mesh (the sequence-placed cache's decode, a
  prefill that makes its own caches) is ``ok``; the walk allocates no
  host memory (every parameter, optimizer and cache block is ``meta``).
- ``StepCount`` logs a collective that its cache answers, and counts
  ``batch_isend_irecv``'s receives as ``collective-permute``.

The walks run in one subprocess (this process opens no process group),
which prints its results as JSON on its last line.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.configs.base import get_config

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r'''
import json, os
import torch
import torch.distributed._functional_collectives as funcol
from repro_torch.configs.base import get_config, get_shape
from repro_torch.distributed import parallel
from repro_torch.distributed.ctx import use_sharding
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.launch import analytic_cost as ac
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, fake_world
from repro_torch.models import zoo

CELLS = [("pod", "smollm-135m", "train_4k", "baseline"),
         ("single", "smollm-135m", "train_4k", "baseline"),
         ("pod", "deepseek-v2-lite-16b", "train_4k", "baseline"),
         ("single", "deepseek-v2-lite-16b", "train_4k", "baseline"),
         ("pod", "qwen2-72b", "decode_32k", "baseline"),
         ("multi", "deepseek-v2-lite-16b", "decode_32k", "baseline"),
         ("multi", "deepseek-v2-lite-16b", "prefill_32k", "baseline")]
out = {"rows": {}}
for mesh, arch, shape, variant in CELLS:
    os.environ["REPRO_TORCH_VARIANT"] = variant
    name, m = dryrun.MESHES[mesh]
    row = dryrun.run_cell(arch, shape, m, name)
    row.pop("traceback", None)
    out["rows"][f"{mesh}|{arch}|{shape}|{variant}"] = row
os.environ["REPRO_TORCH_VARIANT"] = "baseline"


def blocks(tree):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return [b for v in tree.values() for b in blocks(v)]
    if isinstance(tree, (list, tuple)):
        return [b for v in tree for b in blocks(v)]
    if isinstance(tree, torch.Tensor):
        return [getattr(tree, "_local_tensor", tree).device.type]
    return []


# the walk's arguments and the caches a prefill makes hold nothing
devices = set()
with fake_world(dryrun.MESHES["multi"][1]) as m:
    for build, shape in ((dryrun._train, "train_4k"),
                         (dryrun._decode, "decode_32k"),
                         (dryrun._prefill, "prefill_32k")):
        walk = build(get_config("deepseek-v2-lite-16b"), get_shape(shape), m)
        devices |= set(blocks(walk.args))
        if build is dryrun._prefill:
            with use_sharding(walk.rules, m):
                devices |= set(blocks(walk.step(*walk.args)))
out["devices"] = sorted(devices)

# the widths a rank of deepseek's 16x16 train step computes with
cfg = get_config("deepseek-v2-lite-16b")
with fake_world(dryrun.MESHES["pod"][1]) as m:
    walk = dryrun._train(cfg, get_shape("train_4k"), m)
    model = walk.args[0]
    with use_sharding(walk.rules, m):
        with zoo._top_params(model, cfg):
            head = model.embed.table if cfg.tie_embeddings else model.lm_head.w
            widths = [list(model.embed.table.shape), list(head.shape)]
        layer = model.layers[0]
        with parallel.local_params(layer, cfg):
            widths += [list(layer.attn.wkv_b.w.shape),
                       list(layer.attn.wo.w.shape)]
out["widths"] = widths

# a functional collective answered by the count's cache is still logged;
# a ring's receives are collective-permutes
with fake_world(Mesh(("data", "model"), (2, 4))) as m:
    g = m.device_mesh.get_group("model")
    x = torch.empty(3, 5, device="meta")
    with ac.StepCount() as c:
        for _ in range(3):
            funcol.wait_tensor(funcol.all_gather_tensor(x, 0, g))
    out["gathers"] = c.collective_ops
    q = torch.empty(2, 64, 2, 2, 16, device="meta")
    k = torch.empty(2, 64, 2, 16, device="meta")
    with ac.StepCount() as c:
        ring_attention(q, k, k, mesh=m, causal=True)
    out["ring"] = c.collective_ops
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def walked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def row(walked, mesh, arch, shape, variant="baseline"):
    r = walked["rows"][f"{mesh}|{arch}|{shape}|{variant}"]
    assert r["status"] == "ok", r.get("error")
    return r


def test_pod_cell_smollm_train_4k(walked):
    r = row(walked, "pod", "smollm-135m", "train_4k")
    assert r["chips"] == 256 and r["mesh"] == "16x16"
    assert r["fits_hbm"], r["memory"]
    assert r["roofline"]["hlo_flops"] == r["flops_global"] > 1e14
    assert r["collectives"]["total_bytes"] > 0
    assert r["roofline"]["collective_s"] > 0
    assert r["policy"] == "dp_train"


@pytest.mark.parametrize("arch,equal", [("smollm-135m", True),
                                        ("deepseek-v2-lite-16b", False)])
def test_flops_global_against_one_card(walked, arch, equal):
    mesh = row(walked, "pod", arch, "train_4k")
    one = row(walked, "single", arch, "train_4k")
    assert mesh["flops_global"] == mesh["flops_rank"] * 256
    if equal:  # dp_train: every rank its rows of the whole model
        assert mesh["policy"] == "dp_train"
        assert mesh["flops_global"] == pytest.approx(one["flops_global"],
                                                     rel=1e-9)
    else:  # FSDP + TP: replicated work counts once a rank
        assert mesh["policy"] == "train"
        assert mesh["flops_global"] >= one["flops_global"]


def test_vocab_and_mla_split_over_model(walked):
    cfg = get_config("deepseek-v2-lite-16b")
    a, m = cfg.mla, 16
    assert row(walked, "pod", "deepseek-v2-lite-16b",
               "train_4k")["policy"] == "train"
    want = [[cfg.vocab // m, cfg.d_model],
            [cfg.vocab // m, cfg.d_model] if cfg.tie_embeddings
            else [cfg.d_model, cfg.vocab // m],
            [a.kv_lora_rank, cfg.n_heads // m * (a.qk_nope_head_dim +
                                                 a.v_head_dim)],
            [cfg.n_heads // m * a.v_head_dim, cfg.d_model]]
    assert walked["widths"] == want


@pytest.mark.parametrize("mesh,arch,shape", [
    ("pod", "qwen2-72b", "decode_32k"),
    ("multi", "deepseek-v2-lite-16b", "decode_32k"),
    ("multi", "deepseek-v2-lite-16b", "prefill_32k")])
def test_serving_cells_on_the_meshes(walked, mesh, arch, shape):
    r = row(walked, mesh, arch, shape)
    assert r["chips"] == (256 if mesh == "pod" else 512)
    assert r["collectives"]["total_bytes"] > 0
    assert r["roofline"]["collective_s"] > 0
    mem = r["memory"]
    assert mem["total_device_bytes"] == (mem["argument_size_in_bytes"] +
                                         mem["temp_size_in_bytes"]) > 0
    assert r["hbm_model"]["total"] > 0


def test_walk_allocates_nothing(walked):
    assert walked["devices"] == ["meta"]


def test_count_logs_collectives_its_cache_answers(walked):
    # three gathers of a [3, 5] f32 block over the 4 ranks of model
    assert walked["gathers"] == [["all-gather", 4, 240]] * 3
    # k and v, one hop each of 3 around a ring of 4: [1, 2, 16, 16] f32
    assert walked["ring"] == [["collective-permute", 4, 2048]] * 6
