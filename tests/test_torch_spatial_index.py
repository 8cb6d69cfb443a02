"""The port's spatial grid index (``repro_torch.core.spatial_index``, paper
§3.2's extension) against brute force and against the reference's."""
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _torch_ast import code_only
from repro.core import spatial_index as ref
from repro_torch.core.spatial_index import (SpatialGrid,
                                            brute_force_intersections,
                                            conjunctive_intersections)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [16, 64, 128]

# the strategy of tests/test_extensions.py: boxes inside a 192x320 frame
box_st = st.tuples(
    st.integers(0, 160), st.integers(0, 280),
    st.integers(8, 48), st.integers(8, 48),
).map(lambda t: (t[0], t[1], min(t[0] + t[2], 192), min(t[1] + t[3], 320)))


@settings(max_examples=50, deadline=None)
@given(st.lists(box_st, max_size=8), st.lists(box_st, max_size=8),
       st.sampled_from(CELLS))
def test_grid_matches_bruteforce_and_reference(a, b, cell):
    got = conjunctive_intersections(a, b, cell=cell)
    assert got == brute_force_intersections(a, b)
    assert got == ref.conjunctive_intersections(a, b, cell=cell)
    assert got == ref.brute_force_intersections(a, b)


def _boxes(rng, n):
    """Boxes of 1-64 pixels a side, some on cell edges, some degenerate."""
    out = []
    for _ in range(n):
        y1, x1 = (int(v) for v in rng.integers(0, 256, 2))
        if rng.random() < 0.3:
            y1, x1 = y1 // 16 * 16, x1 // 16 * 16
        h, w = (int(v) for v in rng.integers(0, 65, 2))
        out.append((y1, x1, y1 + h, x1 + w))
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_grid_matches_reference_per_cell(cell):
    rng = np.random.default_rng(cell)
    for _ in range(20):
        a, b = _boxes(rng, 12), _boxes(rng, 12)
        got = conjunctive_intersections(a, b, cell=cell)
        assert got == brute_force_intersections(a, b)
        assert got == ref.conjunctive_intersections(a, b, cell=cell)
        grid, want = SpatialGrid(cell=cell), ref.SpatialGrid(cell=cell)
        for box in b:
            assert grid.add(box) == want.add(box)
        for box in a:
            assert grid.candidates(box) == want.candidates(box)
            assert grid.intersections(box) == want.intersections(box)


def test_copy_equals_reference_module():
    port = ROOT / "src" / "repro_torch" / "core" / "spatial_index.py"
    orig = ROOT / "src" / "repro" / "core" / "spatial_index.py"
    assert code_only(port, rename=True) == code_only(orig)
