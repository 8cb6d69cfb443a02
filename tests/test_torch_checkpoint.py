"""The port's checkpoints and recoverable loop (``repro_torch.train``): the
cases of ``tests/test_checkpoint.py`` on tensors, then what the port adds:
a bf16 round trip that is bit-exact (numpy has no bf16), an async save
whose tree is changed in place right after the call, a model restored in
place, and the layout and leaf names of the reference's manifest."""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.utils import tree as jax_tree
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import init_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import (LoopConfig, recoverable_train_loop,
                                       reshard_state)
from repro_torch.utils import tree as port_tree
from repro_torch.utils.tree import flatten_names


def make_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 8), generator=g),
            "opt": {"m": torch.zeros((16, 8)),
                    "step": torch.tensor(0, dtype=torch.int32)}}


def trees_equal(a, b):
    la, lb = flatten_names(a), flatten_names(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


class TestSaveRestore:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        state = make_state()
        mgr.save(7, state)
        got, extra = mgr.restore(make_state(seed=1))
        assert trees_equal(got, state)

    def test_latest_pointer(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        for s in (1, 5, 9):
            mgr.save(s, make_state(s))
        assert mgr.latest_step() == 9
        got, _ = mgr.restore(make_state())
        assert trees_equal(got, make_state(9))

    def test_gc_keeps_k(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in range(5):
            mgr.save(s, make_state(s))
        assert mgr.list_steps() == [3, 4]

    def test_partial_write_is_invisible(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, make_state(1))
        # simulate a crash mid-save: a .tmp dir with garbage
        tmp = pathlib.Path(tmp_path) / "step_000000002.tmp"
        tmp.mkdir()
        (tmp / "shard_0.npz").write_bytes(b"garbage")
        assert mgr.latest_step() == 1
        got, _ = mgr.restore(make_state())
        assert trees_equal(got, make_state(1))

    def test_structure_mismatch_raises(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, make_state())
        with pytest.raises(ValueError, match="structure"):
            mgr.restore({"different": torch.zeros((2,))})

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save_async(3, make_state(3))
        mgr.wait()
        got, _ = mgr.restore(make_state())
        assert trees_equal(got, make_state(3))

    def test_bf16_roundtrip_is_bit_exact(self, tmp_path):
        g = torch.Generator().manual_seed(4)
        bf = (torch.randn((33, 7), generator=g) * 1e3).bfloat16()
        bf[0, :4] = torch.tensor([0.0, -0.0, float("inf"), float("nan")])
        state = {"p": bf, "master": bf.float() + 1e-3,
                 "i": torch.arange(5, dtype=torch.int64)}
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, state)
        manifest = json.loads(
            (tmp_path / "step_000000001" / "manifest.json").read_text())
        assert manifest["leaves"]["p"]["dtype"] == "bfloat16"
        got, _ = mgr.restore({k: torch.zeros_like(v)
                              for k, v in state.items()})
        assert got["p"].dtype == torch.bfloat16
        for k in state:
            assert torch.equal(got[k].view(torch.uint8),
                               state[k].view(torch.uint8)), k

    def test_async_save_snapshots_before_in_place_update(self, tmp_path):
        # the port's train step writes its tensors in place: the snapshot
        # must be taken before save_async returns
        mgr = CheckpointManager(tmp_path)
        state = make_state(5)
        want = {"w": state["w"].clone(),
                "opt": {k: v.clone() for k, v in state["opt"].items()}}
        mgr.save_async(2, state)
        state["w"].add_(100.0)
        state["opt"]["step"].fill_(9)
        mgr.wait()
        got, _ = mgr.restore(make_state())
        assert trees_equal(got, want)

    def test_model_restores_in_place(self, tmp_path):
        cfg = reduce_config(get_config("smollm-135m"))
        saved = init_model(cfg, 1, device="cpu")
        other = init_model(cfg, 2, device="cpu")
        mgr = CheckpointManager(tmp_path)
        mgr.save(3, (saved, {"step": torch.tensor(3)}), extra={"step": 3})
        (model, opt), extra = mgr.restore((other, {"step": torch.tensor(0)}))
        assert model is other and extra == {"step": 3}
        assert int(opt["step"]) == 3
        for (n, a), (_, b) in zip(saved.state_dict().items(),
                                  other.state_dict().items()):
            assert torch.equal(a, b), n

    def test_layout_and_names_follow_the_reference(self, tmp_path):
        # the same tree (sorted dict keys, '/'-joined names), as numpy on
        # both sides, gives the same fingerprint, names and shard layout
        rng = np.random.default_rng(0)
        tree = {"b": {"y": rng.standard_normal((2, 3)).astype(np.float32),
                      "x": np.arange(4, dtype=np.int32)},
                "a": [rng.standard_normal(5).astype(np.float32)]}
        ours = CheckpointManager(tmp_path / "port").save(4, tree)
        ref = JaxCheckpointManager(tmp_path / "ref").save(4, tree)
        mo = json.loads((ours / "manifest.json").read_text())
        mr = json.loads((ref / "manifest.json").read_text())
        for key in ("step", "extra", "fingerprint", "leaves", "n_shards"):
            assert mo[key] == mr[key], key
        assert sorted(p.name for p in ours.iterdir()) == sorted(
            p.name for p in ref.iterdir())
        assert (tmp_path / "port" / "LATEST").read_text() == ours.name


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(1)
    tree = {"z": [np.zeros((2, 3), np.float32), None,
                  (np.arange(4, dtype=np.int64),)],
            "a": {"b": rng.standard_normal(5).astype(np.float32)}}
    names = [n for n, _ in flatten_names(tree)]
    assert names == [n for n, _ in jax_tree.flatten_names(tree)]
    assert port_tree.tree_map_with_name(lambda n, x: n, tree) == \
        jax_tree.tree_map_with_name(lambda n, x: n, tree)
    assert (port_tree.tree_size_bytes(tree)
            == jax_tree.tree_size_bytes(tree) == 24 + 32 + 20)
    assert port_tree.tree_param_count(tree) == \
        jax_tree.tree_param_count(tree) == 15
    # tensors count as the arrays they hold; a module is its state_dict
    as_torch = {"w": torch.zeros((2, 3), dtype=torch.bfloat16)}
    assert port_tree.tree_size_bytes(as_torch) == 12
    cfg = reduce_config(get_config("smollm-135m"))
    model = init_model(cfg, 0, device="cpu")
    assert [n for n, _ in flatten_names(model)] == sorted(
        model.state_dict())
    assert port_tree.tree_param_count(model) == cfg.param_count()


class TestRecoverableLoop:
    def test_loop_recovers_from_fault(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        state = {"x": torch.tensor(0.0)}

        def step_fn(s, batch):
            return {"x": s["x"] + 1.0}, {"x": s["x"]}

        faults = {"armed": True}

        def fault_hook(step):
            if step == 7 and faults["armed"]:
                faults["armed"] = False
                raise RuntimeError("simulated node failure")

        def batches():
            while True:
                yield {}

        final, steps, restarts = recoverable_train_loop(
            state, batches(), step_fn, ckpt=mgr,
            cfg=LoopConfig(total_steps=12, checkpoint_every=5,
                           checkpoint_async=False),
            fault_hook=fault_hook)
        assert restarts == 1
        assert steps == 12
        # deterministic step_fn: recovery from step-5 checkpoint continues
        assert float(final["x"]) == 12.0

    def test_loop_raises_after_max_restarts(self, tmp_path):
        mgr = CheckpointManager(tmp_path)

        def step_fn(s, b):
            raise RuntimeError("always down")

        def batches():
            while True:
                yield {}

        with pytest.raises(RuntimeError):
            recoverable_train_loop(
                {"x": torch.tensor(0.0)}, batches(), step_fn, ckpt=mgr,
                cfg=LoopConfig(total_steps=3, max_restarts=2))

    def test_reshard_state_moves_to_a_device(self):
        cfg = reduce_config(get_config("smollm-135m"))
        model = init_model(cfg, 0, device="cpu")
        state = (model, {"m": {"w": torch.ones(2)}, "step": torch.tensor(1)})
        moved = reshard_state(state, "cpu")
        assert isinstance(moved, tuple) and moved[0] is model
        assert trees_equal(moved[1], state[1])
