"""The collectives of a sharded step, on one rank's local tensors.

The reference lets GSPMD partition its jitted step: the parameters carry
their ``NamedSharding``, and XLA inserts the gathers, reductions and
all-reduces.  The port runs eagerly, so the model code works on local
tensors and this module supplies what GSPMD would have inserted:

- **Parameters.**  ``shard_model`` (``distributed/sharding.py``) makes
  every parameter a ``DTensor`` placed as the reference's
  ``param_pspec`` says.  :func:`local_params` swaps each one, for the
  length of a forward (and of its recomputation under remat), for the
  local tensor the code computes with: gathered over every mesh axis
  (the FSDP all-gather), except where tensor parallelism consumes this
  rank's chunk over the ``model`` axis (:func:`plan`).  The swap goes
  through ``redistribute`` and ``to_local(grad_placements=...)``, so the
  backward turns each local gradient back into the parameter's
  placements: a sum over the batch axes (the reduce-scatter of FSDP), a
  sum over the model axis where each model rank used the weight for its
  own heads, and nothing where every model rank computed the same.
- **Tensor parallelism** (Megatron's schedule, what GSPMD derives for
  the reference's specs): attention over this rank's heads, the MLP over
  its slice of ``d_ff``, the MoE over its experts; the input enters
  through :func:`copy_to` (identity forward, all-reduce of the gradient)
  and the partial output leaves through :func:`reduce_from` (all-reduce
  forward, identity backward).
- **Batch axes.**  Each rank holds its rows of the batch
  (:func:`batch_rows`); the loss is summed over the batch axes with
  :func:`reduce_from`.

With no mesh installed (``ctx.use_sharding``) nothing here runs, and the
one-device path is the one it was.
"""
from __future__ import annotations

import contextlib
import re
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.ctx import current_mesh, current_rules

#: how the model code consumes a parameter (see :func:`plan`)
FULL, SHARD, SPLIT = "full", "shard", "split"


class Group(NamedTuple):
    """One mesh axis seen from this rank: its process group, this rank's
    index along it, its size and its mesh axis name."""

    group: object
    rank: int
    size: int
    axis: str


def _device_mesh():
    mesh = current_mesh()
    return None if mesh is None else mesh.device_mesh


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_tensor(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a ``DTensor``; any other tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def axis_group(axis: Optional[str]) -> Optional[Group]:
    """The installed mesh's axis ``axis`` as a :class:`Group`, or None
    without a built mesh, for ``None`` or for an axis of size 1."""
    dm = _device_mesh()
    if dm is None or axis is None or axis not in dm.mesh_dim_names:
        return None
    size = dm.size(dm.mesh_dim_names.index(axis))
    if size == 1:
        return None
    return Group(dm.get_group(axis), dm.get_local_rank(axis), size, axis)


def logical_group(logical: str) -> Optional[Group]:
    """The group of the mesh axis the installed rules map ``logical``
    (``"heads"``, ``"ff"``, ``"experts"``) to, or None."""
    rules = current_rules()
    axis = rules.rules.get(logical) if rules is not None else None
    return axis_group(axis) if isinstance(axis, str) else None


def batch_axes() -> tuple:
    """The mesh axes the batch is split over (the rules' ``batch``, as
    ``sharding.batch_pspec`` reads it), in mesh order."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None:
        return ()
    dp = rules.rules.get("batch") if rules is not None else None
    if dp is None:
        dp = ("pod", "data")
    dp = dp if isinstance(dp, tuple) else (dp,)
    return tuple(a for a in mesh.axis_names if a in dp)


def batch_groups() -> list:
    """:class:`Group` of each batch axis of size > 1."""
    return [g for g in (axis_group(a) for a in batch_axes()) if g is not None]


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch tensor ``x`` (leading dim over
    the batch axes, the first axis major), or ``x`` itself when no axis
    splits the batch or its length does not divide (as
    ``sharding.batch_shardings`` replicates it)."""
    index, count = 0, 1
    for g in batch_groups():
        index, count = index * g.size + g.rank, count * g.size
    if count == 1 or x.shape[0] % count:
        return x
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`batch_rows`: every rank's rows, concatenated
    in batch order (no gradient)."""
    for g in reversed(batch_groups()):
        parts = [torch.empty_like(x) for _ in range(g.size)]
        dist.all_gather(parts, x.contiguous(), group=g.group)
        x = torch.cat(parts, dim=0)
    return x


# --------------------------------------------------------------------------
# Collectives with their gradients
# --------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, groups):
    """The sum over ``groups``, accumulated in f32 and rounded once to
    ``x``'s dtype (a bf16 sum of M partial outputs would round M - 1
    times, where the one-device path rounds once)."""
    y = x.to(torch.float32, copy=True)
    for g in groups:
        dist.all_reduce(y, group=g.group)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, *groups: Group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``groups``: the entry of
    a tensor-parallel region, whose ranks each take a part of the
    gradient."""
    return _CopyTo.apply(x, groups) if groups else x


def reduce_from(x: torch.Tensor, *groups: Group) -> torch.Tensor:
    """``x`` summed over ``groups``, its gradient passed as it is: the
    exit of a tensor-parallel region (partial outputs), or a loss summed
    over the batch axes."""
    return _ReduceFrom.apply(x, groups) if groups else x


# --------------------------------------------------------------------------
# Which parameters tensor parallelism splits
# --------------------------------------------------------------------------
def attention_group(cfg) -> Optional[Group]:
    """The model group when a GQA attention runs over this rank's heads:
    the rules split heads over an axis of size M > 1, the effective KV
    heads (``n_kv_heads * kv_repeat``) divide M, and the cache is not
    placed by sequence (then every rank computes every head over its
    positions).  MLA runs whole on every rank."""
    g = logical_group("heads")
    if g is None or cfg.mla is not None or cfg.n_heads == 0 \
            or cfg.kv_cache_shard == "seq" \
            or (cfg.n_kv_heads * cfg.kv_repeat) % g.size:
        return None
    return g


def kv_split(cfg, g: Group) -> bool:
    """Under :func:`attention_group`, whether ``wk`` and ``wv`` are split
    by heads too (else every rank projects every KV head and keeps its
    own): without KV replication, KV heads that divide M, and no int8
    cache, whose per-row scales are replicated over the model axis."""
    return (cfg.kv_repeat == 1 and cfg.n_kv_heads % g.size == 0
            and not cfg.kv_cache_quant)


def mlp_group(d_ff: int) -> Optional[Group]:
    g = logical_group("ff")
    return g if g is not None and d_ff % g.size == 0 else None


def moe_group(cfg) -> Optional[Group]:
    """The reference's condition for ``_moe_tp_psum``: the experts' mesh
    axis has size > 1 and divides the routed experts."""
    g = logical_group("experts")
    return g if g is not None and cfg.moe.n_routed % g.size == 0 else None


_ATTN = re.compile(r"^attn\.(wq|wk|wv|wo|q_norm|k_norm)\.(w|b|scale)$")
_MLP = re.compile(r"^(mlp|moe\.shared)\.(gate|up|down)\.w$")
_EXPERTS = re.compile(r"^moe\.(w_gate|w_up|w_down|router\.w)$")


def plan(name: str, cfg) -> tuple:
    """``(kind, dim, group)`` for the parameter ``name`` of a layer
    (``attn.wq.w``, ``mlp.down.w``, ``moe.w_gate``, ...) under ``cfg``:
    ``SHARD`` -- the code takes this rank's chunk of ``dim`` over the
    group's axis; ``SPLIT`` -- it takes the whole, but each rank of the
    group uses it for its own part, so its gradient sums over the group;
    ``FULL`` (group None) -- the whole, used alike on every rank."""
    m = _ATTN.match(name)
    if m:
        g = attention_group(cfg)
        if g is None:
            return FULL, None, None
        proj, leaf = m.groups()
        dim = 1 if leaf == "w" else 0
        if proj == "wq":
            return SHARD, dim, g
        if proj in ("wk", "wv"):
            return (SHARD, dim, g) if kv_split(cfg, g) else (SPLIT, None, g)
        if proj == "wo":
            return SHARD, 0, g
        return SPLIT, None, g  # the per-head norms see this rank's heads
    m = _MLP.match(name)
    if m:
        d_ff = (cfg.d_ff if m.group(1) == "mlp"
                else cfg.moe.d_shared_ff * cfg.moe.n_shared)
        g = mlp_group(d_ff)
        if g is None:
            return FULL, None, None
        return SHARD, (0 if m.group(2) == "down" else 1), g
    m = _EXPERTS.match(name)
    if m:
        g = moe_group(cfg)
        if g is None:
            return FULL, None, None
        # every rank routes all its tokens, but only its experts' outputs
        # carry the routing weights' gradient back to the router
        return (SPLIT, None, g) if m.group(1) == "router.w" else (SHARD, 0, g)
    return FULL, None, None


# --------------------------------------------------------------------------
# Parameters: DTensor -> the local tensor the code computes with
# --------------------------------------------------------------------------
def to_compute(p, kind: str = FULL, dim: Optional[int] = None,
               group: Optional[Group] = None) -> torch.Tensor:
    """The local tensor of the ``DTensor`` ``p`` that the code computes
    with (see :func:`plan`), differentiable back to ``p``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = current_mesh()
    dm = mesh.device_mesh
    batch = batch_axes()
    target, grads, kept = [], [], False
    for axis, pl in zip(dm.mesh_dim_names, p.placements):
        keep = (kind == SHARD and group is not None and axis == group.axis
                and pl == Shard(dim))
        kept = kept or keep
        target.append(pl if keep else Replicate())
        if keep:
            grads.append(pl)
        elif axis in batch or (group is not None and axis == group.axis):
            grads.append(Partial())
        else:
            grads.append(Replicate())
    t = p.redistribute(dm, target).to_local(grad_placements=grads)
    if kind == SHARD and not kept:  # placed whole: take this rank's chunk
        n = t.shape[dim] // group.size
        t = t.narrow(dim, group.rank * n, n)
    return t


@contextlib.contextmanager
def local_params(module: torch.nn.Module, cfg=None, *, skip=()):
    """For the length of the block, each ``DTensor`` parameter of
    ``module`` (but those under the child modules named in ``skip``) is
    replaced by its local compute tensor: as :func:`plan` says for
    ``cfg``'s layer (a ``Block``), or whole when ``cfg`` is None; a plain
    parameter that the plan splits is replaced by this rank's chunk.  A
    no-op without an installed mesh."""
    if _device_mesh() is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    swapped = []
    for prefix, sub in module.named_modules():
        if prefix.split(".")[0] in skip:
            continue
        for leaf, p in list(sub._parameters.items()):
            if p is None:
                continue
            name = f"{prefix}.{leaf}" if prefix else leaf
            kind, dim, g = plan(name, cfg) if cfg is not None else (
                FULL, None, None)
            if isinstance(p, DTensor):
                sub._parameters[leaf] = to_compute(p, kind, dim, g)
            elif kind == SHARD:  # a whole tensor on every rank
                sub._parameters[leaf] = local_slice(p, dim, g)
            else:
                continue
            swapped.append((sub, leaf, p))
    try:
        yield
    finally:
        for sub, leaf, p in swapped:
            sub._parameters[leaf] = p


def local_slice(t: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """This rank's chunk of ``dim`` of a tensor every rank holds whole
    (a layer built without ``shard_model``)."""
    return t.narrow(dim, g.rank * (t.shape[dim] // g.size),
                    t.shape[dim] // g.size)
