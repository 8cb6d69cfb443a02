"""Every cell of the SSM (falcon-mamba-7b) and hybrid (zamba2-1.2b)
families in the port's dry run: ``ok``, or ``skipped`` exactly where the
reference's ``supports_shape`` skips it (neither is: both take
``long_500k``).  Their walks loop over the scans' chunks (128 a layer at
S = 32,768), so they take the longest; the other families are in
``tests/test_torch_dryrun.py``.  falcon-mamba-7b's train_4k and
prefill_32k walk at ``CUT_LAYERS`` of its 64 identical layers (about 35 s
each at full depth on one core): the same shapes and the same scan loop
a layer, and :func:`test_falcon_layers_are_the_same_work` shows that
each layer adds the same FLOPs and argument bytes, so the cut leaves out
only repeats of the layers it walks."""
import dataclasses
import importlib.util
import pathlib

import pytest

from repro_torch.configs.base import SHAPES, ShapeSpec, get_config
from repro_torch.launch import analytic_cost as ac
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "_torch_dryrun_tests", ROOT / "tests" / "test_torch_dryrun.py")
CELLS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CELLS)

#: the cells walked at a cut depth, and that depth
CUT = {("falcon-mamba-7b", "train_4k"), ("falcon-mamba-7b", "prefill_32k")}
CUT_LAYERS = 2


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_cell_of_a_family(family, shape, monkeypatch):
    arch = CELLS.FAM.FAMILIES[family]
    if (arch, shape) in CUT:
        monkeypatch.setattr(dryrun, "get_config", lambda a: (
            dataclasses.replace(get_config(a), n_layers=CUT_LAYERS)))
    CELLS.check_row(arch, shape, dryrun.run_cell(
        arch, shape, make_production_mesh(), dryrun.MESH_NAME))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_falcon_layers_are_the_same_work(kind):
    """falcon-mamba-7b at full width on B=2 x S=512 (two scan chunks a
    layer) at 1, 2 and 3 layers: each layer adds the same counted FLOPs
    and the same argument bytes."""
    mesh = make_production_mesh()
    shape = ShapeSpec("s", kind, 512, 2)
    build = {"train": dryrun._train, "prefill": dryrun._prefill}[kind]
    flops, held = [], []
    for layers in (1, 2, 3):
        cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                                  n_layers=layers)
        walk = build(cfg, shape, mesh)
        with ac.StepCount(walk.tiling) as count:
            walk.step(*walk.args)
        flops.append(count.flops * walk.times)
        held.append(walk.held_bytes)
    assert flops[2] - flops[1] == flops[1] - flops[0] > 0
    assert held[2] - held[1] == held[1] - held[0] > 0
