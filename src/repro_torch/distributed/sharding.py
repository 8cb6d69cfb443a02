"""Parameter / cache / input PartitionSpec assignment, and the DTensors
that carry it.

Counterpart of the reference's ``distributed/sharding.py``.  Params are
matched by their tree-path name against a rule table.  Two modes:

- ``train``: FSDP (ZeRO-3) over 'data' + TP over 'model'.  Every large matrix
  is sharded on both axes; optimizer state inherits the same specs.
- ``serve``: TP over 'model' only (params replicated over 'data' so decode
  never all-gathers weights across the batch axis).

Stacked-layer params ([L, ...]) get a leading None.  Dims that do not divide
the mesh axis fall back to None (replicated) — e.g. smollm's 9 attention
heads on a 16-way model axis.

The rule table and the spec functions (``param_pspec``, ``batch_pspec``,
``cache_pspec``, ``choose_policy``, ``choose_serve_cache_policy``) are the
reference's, verbatim but for the variant switch's name
(``REPRO_TORCH_VARIANT``); they read only ``mesh.shape`` ({axis: size})
and ``mesh.axis_names``, so they take ``launch.mesh.Mesh``, built over
ranks or only described.  The port keeps one module per layer where the
reference stacks them: layer ``i``'s ``layers.<i>.<rest>`` is the
reference's ``layers/<rest>`` (``models/convert.py``), and its spec is the
reference's without the leading stacked ``None`` (:func:`port_pspec`).
The decode cache keeps the reference's stacked layout, so ``cache_pspec``
applies to it as it stands.

What the port adds is the plumbing from a spec to ``torch.distributed``:
:func:`to_placements` (an entry naming a tuple of mesh axes shards that
dimension over each of them, the first major, as JAX lays them out),
:class:`NamedSharding`, and :func:`shard_model`, :func:`shard_cache`
(``DTensor`` parameters and caches), :func:`batch_shardings`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.ctx import P
from repro_torch.utils.tree import tree_map_with_name

# (regex on param path, spec WITHOUT the stacked-layer axis)
# 'F' = fsdp axis placeholder, 'M' = model/tensor axis placeholder.
_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$", ("M", "F")),
    (r"lm_head/w$", ("F", "M")),
    (r"projector/fc\d/w$", ("F", "M")),
    (r"projector/fc\d/b$", ("M",)),
    # attention
    (r"attn/w[qkv]/w$", ("F", "M")),
    (r"attn/w[qkv]/b$", ("M",)),
    (r"attn/wo/w$", ("M", "F")),
    (r"attn/wq_[ab]/w$", ("F", "M")),
    (r"attn/wkv_a/w$", ("F", None)),
    (r"attn/wkv_b/w$", (None, "M")),
    (r"cross/w[qkv]/w$", ("F", "M")),
    (r"cross/wo/w$", ("M", "F")),
    # mlp
    (r"mlp/(gate|up)/w$", ("F", "M")),
    (r"mlp/down/w$", ("M", "F")),
    (r"shared/(gate|up)/w$", ("F", "M")),
    (r"shared/down/w$", ("M", "F")),
    # moe (experts sharded over model; replicated router)
    (r"moe/router/w$", (None, None)),
    (r"moe/w_(gate|up)$", ("M", "F", None)),
    (r"moe/w_down$", ("M", None, "F")),
    # mamba1
    (r"mamba/in_proj/w$", ("F", "M")),
    (r"mamba/conv_w$", (None, "M")),
    (r"mamba/conv_b$", ("M",)),
    (r"mamba/x_proj/w$", ("M", None)),
    (r"mamba/dt_proj/w$", (None, "M")),
    (r"mamba/dt_proj/b$", ("M",)),
    (r"mamba/A_log$", ("M", None)),
    (r"mamba/D$", ("M",)),
    (r"mamba/out_proj/w$", ("M", "F")),
    # mamba2 (split projections)
    (r"mamba/in_[zx]/w$", ("F", "M")),
    (r"mamba/in_[BC]/w$", ("F", None)),
    (r"mamba/in_dt/w$", ("F", "M")),
    (r"mamba/conv_x_w$", (None, "M")),
    (r"mamba/conv_x_b$", ("M",)),
    (r"mamba/conv_[BC]_[wb]$", None),  # tiny: replicate
    (r"mamba/norm/scale$", ("M",)),
    # zamba shared block out-proj
    (r"shared_attn/out_proj/w$", ("M", "F")),
    # norms and everything else default to replicated
]

_STACKED_PREFIXES = ("layers/", "enc_layers/", "dec_layers/", "dense_layers/")


def _match_rule(name: str) -> Optional[tuple]:
    for pat, spec in _RULES:
        if re.search(pat, name):
            return spec if spec is not None else ()
    return ()


def param_pspec(name: str, leaf, cfg: ArchConfig, mesh, *,
                mode: str = "train") -> P:
    """PartitionSpec for one named param leaf."""
    spec = list(_match_rule(name))
    stacked = name.startswith(_STACKED_PREFIXES)
    axes: list = []
    fsdp_ok = mode in ("train", "dp_train") and "data" in mesh.axis_names
    dp_all = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    shape = leaf.shape[1:] if stacked else leaf.shape
    # pad spec to rank
    spec = spec + [None] * (len(shape) - len(spec))
    for dim, ax in zip(shape, spec):
        if ax == "F":
            if mode == "dp_train":
                ax = dp_all  # FSDP over the full mesh (TP=1 policy)
            else:
                ax = "data" if fsdp_ok else None
        elif ax == "M":
            if mode == "dp_train":
                ax = None
            else:
                ax = "model" if "model" in mesh.axis_names else None
        if ax is not None:
            size = (np.prod([mesh.shape[a] for a in ax])
                    if isinstance(ax, tuple) else mesh.shape[ax])
            if dim % int(size) != 0:
                ax = None  # non-divisible dims fall back to replication
        axes.append(ax)
    if stacked:
        axes = [None] + axes
    return P(*axes)


def batch_pspec(mesh, rules=None) -> P:
    """Input batch: leading dim over the active data-parallel axes."""
    if rules is not None and rules.rules.get("batch") is not None:
        dp = rules.rules["batch"]
        dp = dp if isinstance(dp, tuple) else (dp,)
        dp = tuple(a for a in dp if a in mesh.axis_names)
    else:
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return P(dp if dp else None)


def cache_pspec(name: str, leaf, cfg: ArchConfig, mesh) -> P:
    """Decode-cache sharding: batch over 'data', kv-heads over 'model'.

    Cache leaves are stacked [L, B, S, ...]; MLA latent ([L,B,S,r]) and SSM
    conv/ssm states shard batch only (plus head/channel dims over model where
    divisible).
    """
    model_ok = "model" in mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp_size = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    shape = leaf.shape
    axes: list = [None] * len(shape)
    # leading stacked-layer axis, then batch over the full DP product
    if len(shape) >= 2 and dp:
        if shape[1] % dp_size == 0:
            axes[1] = dp if len(dp) > 1 else dp[0]
        elif "data" in dp and shape[1] % mesh.shape["data"] == 0:
            axes[1] = "data"
    if name.endswith(("/k", "/v", "/k_scale", "/v_scale")) and model_ok and \
            cfg.kv_cache_shard == "seq" and len(shape) >= 3 and \
            shape[2] % mesh.shape["model"] == 0:
        # flash-decode-style: shard the cache SEQUENCE over the TP group; the
        # softmax statistics / output partials combine with tiny collectives
        axes[2] = "model"
    elif name.endswith(("/k", "/v")) and len(shape) == 5 and model_ok:
        if shape[3] % mesh.shape["model"] == 0:
            axes[3] = "model"  # kv heads
        elif shape[4] % mesh.shape["model"] == 0:
            # head_dim fallback: keeps the cache sharded when KV heads do not
            # divide the TP axis (e.g. yi-34b kv=8 on 16-way model); GSPMD
            # partial-sums the score contraction.  Costly in collectives —
            # superseded by the shard_map flash-decode path (see SS Perf).
            axes[4] = "model"
    if "ssm" in name and len(shape) == 5 and model_ok:
        if shape[2] % mesh.shape["model"] == 0:
            axes[2] = "model"  # mamba2 ssm state heads [L,B,H,P,N]
    if ("conv_x" in name or name.endswith("/conv")) and len(shape) == 4 and model_ok:
        if shape[3] % mesh.shape["model"] == 0:
            axes[3] = "model"  # conv channels
    if name.endswith("/ssm") and len(shape) == 4 and model_ok:
        if shape[2] % mesh.shape["model"] == 0:
            axes[2] = "model"  # mamba1 ssm state [L,B,di,N]
    return P(*axes)


def choose_policy(cfg, mesh, kind: str = "train") -> str:
    """Per-arch parallelism policy (SS Perf iteration 1): small models whose
    FSDP-sharded step state fits one chip run pure-DP (TP=1) — activation
    collectives vanish and only FSDP gathers remain.  Large models keep
    FSDP+TP."""
    import os

    if os.environ.get("REPRO_TORCH_VARIANT") == "fsdp_tp":
        return "train"
    if kind != "train":
        return "serve"
    n = cfg.param_count()
    chips = float(np.prod(list(mesh.shape.values())))
    state_bytes = n * 16.0 / chips      # fp32 param+m+v, bf16 copy
    layer_bytes = n / max(cfg.n_layers + cfg.enc_layers, 1) * 2.0
    # pure DP needs the sharded state plus one gathered layer in flight
    if state_bytes + 3 * layer_bytes < 4e9:
        return "dp_train"
    return "train"


def choose_serve_cache_policy(cfg, mesh) -> dict:
    """Per-arch serving cache policy (SS Perf iteration):

    - hybrid (zamba2): the wide shared-attention cache regresses under
      sequence sharding / quantization (GSPMD reshards the dequantized
      cache) -> plain heads-sharded bf16 cache.
    - GQA archs whose KV heads do NOT divide the TP axis (kv_repeat > 1 or
      head-dim fallback): flash-decode-style sequence-sharded cache with
      kv_repeat=1, plus int8 quantization.
    - GQA archs that shard evenly: keep heads sharding, add int8 quant
      (halves the decode memory term at no collective cost).
    - MLA / SSM: unchanged (latent / state caches).
    """
    if cfg.family in ("hybrid",) or cfg.n_heads == 0:
        return {"kv_cache_quant": False, "kv_cache_shard": "heads"}
    if cfg.mla is not None:
        # MLA: quantize the rank-r latent (the cache IS the latent); no head
        # sharding applies — the absorbed decode reads it per q-head locally
        return {"kv_cache_quant": True, "kv_cache_shard": "heads"}
    model = mesh.shape.get("model", 1)
    needs_seq = (cfg.kv_repeat > 1
                 or (cfg.n_kv_heads and cfg.n_kv_heads % model != 0))
    if needs_seq:
        return {"kv_cache_quant": True, "kv_cache_shard": "seq",
                "kv_repeat": 1}
    return {"kv_cache_quant": True, "kv_cache_shard": "heads"}

# --------------------------------------------------------------------------
# Specs -> torch.distributed placements
# --------------------------------------------------------------------------
def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``: ``Shard(d)`` on each
    mesh axis an entry names for dimension ``d`` (a tuple entry on each of
    its axes, which must come in mesh order, the first major), and
    ``Replicate()`` on every other axis."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``jax.sharding.NamedSharding``):
    ``placements`` are its DTensor placements over ``mesh.device_mesh``."""

    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)

    def local_shape(self, shape) -> tuple:
        """The shape of one rank's block of an array of ``shape``."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            if entry is not None:
                out[d] //= int(np.prod([self.mesh.shape[a] for a in (
                    entry if isinstance(entry, tuple) else (entry,))]))
        return tuple(out)

    def distribute(self, t: torch.Tensor):
        """``t`` (the same whole tensor on every rank) as a DTensor: each
        rank keeps its block, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh.device_mesh, self.placements,
                                 src_data_rank=None)


_STACKS = ("layers", "enc_layers", "dec_layers", "dense_layers")


def reference_name(name: str) -> tuple:
    """``(reference tree name, stacked)`` of a port state-dict name:
    ``layers.3.attn.wq.w`` is ``layers/attn/wq/w`` of the stack,
    ``embed.table`` is ``embed/table``."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in _STACKS and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def port_pspec(name: str, leaf, cfg: ArchConfig, mesh, *,
               mode: str = "train") -> P:
    """The reference's ``param_pspec`` of a port parameter: a layer's
    leaf is matched as the stacked leaf (a leading layer axis of 1) and
    loses the stacked ``None``."""
    ref, stacked = reference_name(name)

    class _Shape:
        shape = ((1,) if stacked else ()) + tuple(leaf.shape)

    spec = param_pspec(ref, _Shape, cfg, mesh, mode=mode)
    return P(*spec[1:]) if stacked else spec


def param_shardings(model, cfg: ArchConfig, mesh, *, mode="train") -> dict:
    """{state-dict name: NamedSharding} of ``model``'s parameters."""
    return {name: NamedSharding(mesh, port_pspec(name, p, cfg, mesh,
                                                 mode=mode))
            for name, p in model.named_parameters()}


def shard_model(model, cfg: ArchConfig, mesh, *, mode="train"):
    """Every parameter of ``model`` made a ``DTensor`` over
    ``mesh.device_mesh`` placed as :func:`param_pspec` says for ``mode``
    (each rank keeps its block of the whole, which every rank must hold
    alike: the same seed).  In place; returns the model."""
    shards = param_shardings(model, cfg, mesh, mode=mode)
    for name, sharding in shards.items():
        owner, _, leaf = name.rpartition(".")
        sub = model.get_submodule(owner)
        p = sub._parameters[leaf]
        sub._parameters[leaf] = torch.nn.Parameter(
            sharding.distribute(p.detach()), requires_grad=p.requires_grad)
    return model


def batch_shardings(batch, mesh, rules=None):
    """NamedSharding of each leaf of ``batch``: leading dim over the
    batch axes where it divides, else replicated."""
    spec = batch_pspec(mesh, rules)

    def one(_, leaf):
        dp_axes = spec[0]
        if dp_axes is None:
            return NamedSharding(mesh, P())
        size = int(np.prod([mesh.shape[a] for a in (
            dp_axes if isinstance(dp_axes, tuple) else (dp_axes,))]))
        if leaf.shape and leaf.shape[0] % size == 0:
            return NamedSharding(mesh, P(*([spec[0]] + [None] * (len(leaf.shape) - 1))))
        return NamedSharding(mesh, P())

    return tree_map_with_name(one, batch)


def cache_shardings(caches, cfg: ArchConfig, mesh):
    return tree_map_with_name(
        lambda name, leaf: NamedSharding(mesh, cache_pspec(name, leaf, cfg, mesh)),
        caches)


def _contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def shard_cache(cache_specs: dict, cfg: ArchConfig, mesh,
                device=None) -> dict:
    """Zeroed decode caches as DTensors placed by :func:`cache_pspec`,
    from ``zoo.init_cache_specs``' ``meta`` tensors: each rank allocates
    only its block, on the mesh's device, or with ``device="meta"`` none
    at all (a dry run's walk)."""
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh
    if device is None or torch.device(device).type != "meta":
        device = (dm.device_type if dm.device_type != "cuda" else
                  torch.device("cuda", torch.cuda.current_device()))
    shards = cache_shardings(cache_specs, cfg, mesh)
    return {key: {n: DTensor.from_local(
        torch.zeros(shards[key][n].local_shape(t.shape), dtype=t.dtype,
                    device=device),
        dm, shards[key][n].placements, shape=t.shape,
        stride=_contiguous_strides(t.shape))
        for n, t in stack.items()}
        for key, stack in cache_specs.items()}
