"""The traffic generators repeat by seed, and every seed sends the same
work in another order."""
import itertools

import numpy as np
from conftest import ANALYTICS, PREFILL, tiny_cell

from loops import analytics, batcher


def _queries(cell, seed, n):
    gen = analytics.queries(cell.traffic, cell.config,
                            cell.config["vocab_size"], seed)
    return [(l, f, t.tolist()) for l, f, t in itertools.islice(gen, n)]


def test_queries_repeat_by_seed_and_cover_each_cycle():
    cell = tiny_cell(ANALYTICS)
    big = 2 ** 31 + 77
    assert _queries(cell, big, 18) == _queries(cell, big, 18)
    assert _queries(cell, big, 18) != _queries(cell, big + 1, 18)
    cycle = 6   # two labels x starts 0, 8, 16
    for seed in (1, big):
        qs = _queries(cell, seed, 3 * cycle)
        for k in range(3):
            got = sorted((l, f) for l, f, _ in qs[k * cycle:(k + 1) * cycle])
            assert got == sorted((l, f) for l in ("car", "person")
                                 for f in (0, 8, 16))


def _prompts(cell, seed, n):
    gen = batcher.prompts(cell.traffic, cell.config["vocab_size"], seed)
    return [p.tolist() for p in itertools.islice(gen, n)]


def test_prompts_repeat_by_seed():
    cell = tiny_cell(PREFILL)
    big = 2 ** 31 + 3
    assert _prompts(cell, big, 40) == _prompts(cell, big, 40)
    assert _prompts(cell, big, 40) != _prompts(cell, big + 1, 40)


def test_every_seed_sends_each_cycle_in_its_own_order():
    """Each cycle holds the same lengths whatever the seed, log-uniform
    between the mix's bounds, and the seeds order them differently, so
    which prompts share a prefill is left to the batcher."""
    cell = tiny_cell(PREFILL)
    mix = cell.traffic
    per = mix["cycle_prompts"]
    base = sorted(batcher.cycle_lengths(mix).tolist())
    orders = set()
    for seed in (0, 5, 2 ** 31 + 9):
        lens = [len(p) for p in _prompts(cell, seed, 3 * per)]
        for k in range(3):
            assert sorted(lens[k * per:(k + 1) * per]) == base
        orders.add(tuple(lens))
    assert len(orders) == 3
    assert mix["prompt_min"] <= base[0] and base[-1] <= mix["prompt_max"]
    logs = np.log(base)
    steps = np.diff(logs)
    assert np.allclose(steps, steps.mean(), atol=0.05)


def test_check_order_repeats_by_seed():
    cell = tiny_cell(PREFILL)
    mix = cell.traffic
    for seed in (3, 2 ** 31 + 1):
        pick = batcher.check_order(mix, seed)
        assert len(set(pick)) == mix["check_waves"]
        assert all(0 <= i < mix["check_from"] for i in pick)
        assert pick == batcher.check_order(mix, seed)
