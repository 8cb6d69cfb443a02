"""Logical-axis sharding context.

Counterpart of the reference's ``distributed/ctx.py``.  Model code names
*logical* axes (``"batch"``, ``"heads"``, ``"ff"``, ...).  A
:class:`ShardingRules` installed with ``use_sharding(rules, mesh)`` maps
them to mesh axes; with no context installed (unit tests, one-device
runs) every call here is the identity, so model code is the same on one
device and on a mesh.

The rule tables and ``dp_rules`` are the reference's, verbatim.  A
``PartitionSpec`` is the port's own :class:`P`: a tuple whose entries are
a mesh axis name, a tuple of names or ``None``, as JAX's.  The mesh is
``repro_torch.launch.mesh.Mesh`` (``.shape`` maps each axis to its size,
``.axis_names`` orders them; ``.device_mesh`` is the
``torch.distributed`` ``DeviceMesh`` of a mesh built with
``launch.mesh.init_mesh``).  ``constrain`` is the reference's
``with_sharding_constraint``: on a ``DTensor`` it redistributes to the
spec's placements, on a plain tensor it changes nothing.

The reference's ``REPRO_VARIANT`` switch (``nosp``: no sequence
sharding) is read under the port's name ``REPRO_TORCH_VARIANT``.
"""
from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

_state = threading.local()


class P(tuple):
    """PartitionSpec: one entry per array dimension, each a mesh axis
    name, a tuple of names (the dimension split over their product) or
    ``None`` (replicated).  As JAX's, a tuple of one name is that name
    and an empty tuple is ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (str, tuple of str, or None)."""

    rules: dict = field(default_factory=dict)

    def spec(self, *logical_axes: Optional[str]) -> P:
        return P(*[self.rules.get(a) if a is not None else None for a in logical_axes])


# Default logical->mesh mapping for the production mesh (pod, data, model).
# 'batch' shards over the full data-parallel product; 'model'-ish axes over TP.
TRAIN_RULES = ShardingRules(rules={
    "batch": ("pod", "data"),
    "seq": None,
    "model_dim": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "d_state": None,
    "fsdp": "data",  # parameter sharding axis (ZeRO-3)
    "seq_shard": "model",  # sequence parallelism (long-context decode)
})

# Serving: no FSDP (params TP-only), batch over data.
SERVE_RULES = ShardingRules(rules={**TRAIN_RULES.rules, "fsdp": None})

# Single-pod variants (no 'pod' axis in the mesh).
TRAIN_RULES_1POD = ShardingRules(rules={**TRAIN_RULES.rules, "batch": "data"})
SERVE_RULES_1POD = ShardingRules(rules={**SERVE_RULES.rules, "batch": "data"})

# Pure-DP policy for small models (TP=1): batch and FSDP span BOTH mesh
# axes; no tensor sharding, so the only collectives are FSDP param gathers
# and gradient reduce-scatters.  Selected per-arch (see sharding.choose_policy).
def dp_rules(mesh_axes: tuple) -> ShardingRules:
    dp = tuple(a for a in ("pod", "data", "model") if a in mesh_axes)
    return ShardingRules(rules={
        "batch": dp, "seq": None, "model_dim": None, "heads": None,
        "kv_heads": None, "ff": None, "vocab": None, "experts": None,
        "d_state": None, "fsdp": dp, "seq_shard": None,
    })


def _variant() -> str:
    return os.environ.get("REPRO_TORCH_VARIANT", "baseline")


def current_rules() -> Optional[ShardingRules]:
    rules = getattr(_state, "rules", None)
    if rules is not None and _variant() == "nosp" and \
            rules.rules.get("seq_shard") is not None:
        rules = ShardingRules(rules={**rules.rules, "seq_shard": None})
    return rules


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_sharding(rules: ShardingRules, mesh=None):
    prev_r = getattr(_state, "rules", None)
    prev_m = getattr(_state, "mesh", None)
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev_r, prev_m


def _axis_size(mesh, ax) -> int:
    if isinstance(ax, tuple):
        size = 1
        for a in ax:
            size *= mesh.shape[a]
        return size
    return mesh.shape[ax]


def constrain(x, *logical_axes: Optional[str]):
    """Redistribute a ``DTensor`` to the spec of ``logical_axes`` if a
    context with a built mesh is installed; else identity (a plain tensor
    is one rank's own data and is returned as it is).

    Logical axes whose mesh size does not divide the array dim are dropped
    (replicated) — this lets one call site serve e.g. both 32k prefill
    (sequence-shardable) and single-token decode.
    """
    from torch.distributed.tensor import DTensor

    rules = current_rules()
    mesh = current_mesh()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    spec = rules.spec(*logical_axes)
    axes = []
    for dim, ax in zip(x.shape, spec):
        if ax is not None and dim % _axis_size(mesh, ax) != 0:
            ax = None
        axes.append(ax)
    from repro_torch.distributed.sharding import to_placements

    return x.redistribute(mesh.device_mesh, to_placements(P(*axes), mesh))

