"""The port's sharding specs (``repro_torch.distributed``) against the
reference's ``distributed/`` functions, with no process group: the
reference's ``param_pspec``, ``cache_pspec``, ``batch_pspec``,
``choose_policy`` and ``choose_serve_cache_policy`` read only
``mesh.shape`` and ``mesh.axis_names``, so both take the port's described
``launch.mesh.Mesh`` (1x1, 2x2, 2x4, the reference's 16x16 production
slice and its 2x16x16 multi-pod layout).  Every leaf of every arch in
``configs/`` (the reference's from ``jax.eval_shape`` of its
``init_model`` and its ``init_cache_specs``; the port's from its model and
cache specs on ``meta``) must get an equal spec tuple, in the modes
``train``, ``serve`` and ``dp_train``; a port layer's leaf ``layers.<i>.<rest>``
is the reference's stacked ``layers/<rest>`` without its leading
``None``.  The placements of a spec (``to_placements``) and a block's
local shape are checked too."""
import dataclasses
import functools

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jax_get_config
from repro.distributed import ctx as jax_ctx
from repro.distributed import sharding as jax_shd
from repro.models import zoo as jax_zoo
from repro.utils.tree import flatten_names as jax_flatten_names
from repro_torch.configs.base import get_config
from repro_torch.distributed import ctx, sharding
from repro_torch.distributed.ctx import P
from repro_torch.launch.mesh import Mesh
from repro_torch.models import zoo

MESHES = {"1x1": Mesh(("data", "model"), (1, 1)),
          "2x2": Mesh(("data", "model"), (2, 2)),
          "2x4": Mesh(("data", "model"), (2, 4)),
          "16x16": Mesh(("data", "model"), (16, 16)),
          "2x16x16": Mesh(("pod", "data", "model"), (2, 16, 16))}
MODES = ("train", "serve", "dp_train")


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str) -> dict:
    cfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda: jax_zoo.init_model(cfg, jax.random.key(0)))
    return dict(jax_flatten_names(shapes))


@functools.lru_cache(maxsize=None)
def _port_model(arch: str):
    return zoo.Model(get_config(arch), device="meta")


def _spec(s) -> tuple:
    return tuple(s)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    ref = _reference_leaves(arch)
    model = _port_model(arch)
    names = dict(model.named_parameters())
    seen = set()
    for mode in MODES:
        for name, p in names.items():
            ref_name, stacked = sharding.reference_name(name)
            leaf = ref[ref_name]
            want = _spec(jax_shd.param_pspec(ref_name, leaf, jcfg, m,
                                             mode=mode))
            if stacked:
                assert want[0] is None, (name, want)
                want = want[1:]
            got = sharding.port_pspec(name, p, tcfg, m, mode=mode)
            assert _spec(got) == want, (mode, name, got, want)
            # the verbatim function on the stacked leaf gives the same
            assert _spec(sharding.param_pspec(ref_name, leaf, tcfg, m,
                                              mode=mode)) == _spec(
                jax_shd.param_pspec(ref_name, leaf, jcfg, m, mode=mode))
            seen.add(ref_name)
    assert seen == set(ref), sorted(set(ref) ^ seen)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_and_policies_equal_reference(arch, mesh):
    m = MESHES[mesh]
    for kw in ({}, dict(kv_cache_shard="seq"), dict(kv_cache_quant=True),
               dict(kv_cache_shard="seq", kv_cache_quant=True)):
        jcfg = dataclasses.replace(jax_get_config(arch), **kw)
        tcfg = dataclasses.replace(get_config(arch), **kw)
        want = dict(jax_flatten_names(jax_zoo.init_cache_specs(jcfg, 32,
                                                               256)))
        got = sharding.cache_shardings(zoo.init_cache_specs(tcfg, 32, 256),
                                       tcfg, m)
        got = {f"{k}/{n}": s for k, stack in got.items()
               for n, s in stack.items()}
        assert sorted(got) == sorted(want)
        for name, leaf in want.items():
            assert _spec(got[name].spec) == _spec(jax_shd.cache_pspec(
                name, leaf, jcfg, m)), (kw, name)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for kind in ("train", "serve"):
        assert sharding.choose_policy(tcfg, m, kind) == \
            jax_shd.choose_policy(jcfg, m, kind)
    assert sharding.choose_serve_cache_policy(tcfg, m) == \
        jax_shd.choose_serve_cache_policy(jcfg, m)
    for rules in (None, ctx.TRAIN_RULES, ctx.SERVE_RULES_1POD,
                  ctx.dp_rules(m.axis_names)):
        jrules = None if rules is None else jax_ctx.ShardingRules(
            rules=dict(rules.rules))
        assert _spec(sharding.batch_pspec(m, rules)) == _spec(
            jax_shd.batch_pspec(m, jrules))


def test_rule_tables_are_the_references():
    for name in ("TRAIN_RULES", "SERVE_RULES", "TRAIN_RULES_1POD",
                 "SERVE_RULES_1POD"):
        assert getattr(ctx, name).rules == getattr(jax_ctx, name).rules
    for axes in (("data", "model"), ("pod", "data", "model"), ("data",)):
        assert ctx.dp_rules(axes).rules == jax_ctx.dp_rules(axes).rules
    assert sharding._RULES == jax_shd._RULES
    rules = ctx.TRAIN_RULES_1POD
    assert _spec(rules.spec("batch", None, "heads")) == _spec(
        jax_ctx.TRAIN_RULES_1POD.spec("batch", None, "heads"))


def test_variant_switches_read_the_ports_name(monkeypatch):
    m = MESHES["16x16"]
    cfg = get_config("smollm-135m")
    assert sharding.choose_policy(cfg, m) == "dp_train"
    monkeypatch.setenv("REPRO_TORCH_VARIANT", "fsdp_tp")
    assert sharding.choose_policy(cfg, m) == "train"
    with ctx.use_sharding(ctx.TRAIN_RULES, m):
        assert ctx.current_rules().rules["seq_shard"] == "model"
        monkeypatch.setenv("REPRO_TORCH_VARIANT", "nosp")
        assert ctx.current_rules().rules["seq_shard"] is None
        assert ctx.current_mesh() is m
    assert ctx.current_rules() is None and ctx.current_mesh() is None


def test_constrain_is_identity_on_plain_tensors():
    x = torch.ones(4, 8)
    assert ctx.constrain(x, "batch", None) is x
    with ctx.use_sharding(ctx.TRAIN_RULES_1POD, MESHES["2x4"]):
        assert ctx.constrain(x, "batch", "heads") is x


def test_batch_shardings():
    m = MESHES["2x4"]
    batch = {"tokens": torch.empty(8, 32), "odd": torch.empty(3, 5),
             "frames": torch.empty(16, 4, 2)}
    got = sharding.batch_shardings(batch, m, ctx.dp_rules(m.axis_names))
    assert got["tokens"].spec == P(("data", "model"), None)
    assert got["odd"].spec == P()
    assert got["frames"].spec == P(("data", "model"), None, None)
    got = sharding.batch_shardings(batch, m, ctx.TRAIN_RULES_1POD)
    assert got["tokens"].spec == P("data", None)
    assert got["tokens"].placements == [Shard(0), Replicate()]


@pytest.mark.parametrize("spec,mesh,want", [
    (P(("data", "model"), None), "2x4", [Shard(0), Shard(0)]),
    (P("model", "data"), "2x4", [Shard(1), Shard(0)]),
    (P(None, "model"), "2x4", [Replicate(), Shard(1)]),
    (P(), "1x1", [Replicate(), Replicate()]),
    (P(None, ("pod", "data"), "model"), "2x16x16",
     [Shard(1), Shard(1), Shard(2)]),
])
def test_to_placements(spec, mesh, want):
    m = MESHES[mesh]
    assert sharding.to_placements(spec, m) == want


def test_to_placements_refuses_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="axis order"):
        sharding.to_placements(P(("model", "data")), MESHES["2x4"])


def test_local_shape_of_a_block():
    s = sharding.NamedSharding(MESHES["2x4"], P(("data", "model"), "model"))
    assert s.local_shape((16, 8)) == (2, 2)
    assert sharding.NamedSharding(MESHES["2x4"], P()).local_shape(
        (3, 5)) == (3, 5)


@pytest.mark.parametrize("name,want", [
    ("layers.3.attn.wq.w", ("layers/attn/wq/w", True)),
    ("dense_layers.0.mlp.down.w", ("dense_layers/mlp/down/w", True)),
    ("enc_layers.11.attn.wo.w", ("enc_layers/attn/wo/w", True)),
    ("shared_attn.attn.wq.w", ("shared_attn/attn/wq/w", False)),
    ("embed.table", ("embed/table", False)),
])
def test_reference_name(name, want):
    assert sharding.reference_name(name) == want
