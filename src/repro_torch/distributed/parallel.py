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
  the reference's specs): attention over this rank's heads (MLA's too:
  its query and up-projection columns and its output rows, the latent's
  down-projection whole), the MLP over its slice of ``d_ff``, the MoE
  over its experts, the vocabulary over its rows of the embedding and
  its columns of the output projection (:func:`vocab_group`: a masked
  lookup summed over ``model``, and a loss and greedy argmax that never
  gather the whole logits); the input enters
  through :func:`copy_to` (identity forward, all-reduce of the gradient)
  and the partial output leaves through :func:`reduce_from` (all-reduce
  forward, identity backward).  Each split product keeps every rank's
  part in f32 up to its sum and rounds once after it, as the one-device
  product does: forward over this rank's rows (:func:`row_product`,
  ``models/layers.py::dense_rows``), backward the input gradient of the
  column-split projections (:func:`column_products`,
  ``models/layers.py::dense_cols``) and of a whole tensor each rank
  reads for its own part (:func:`copy_to_f32`).  The other families,
  each as GSPMD would derive it from the reference's specs: the Mamba
  mixers over this rank's channels (Mamba-1) or heads (Mamba-2), with
  the partial products that every channel reads (Mamba-1's ``x_proj``,
  Mamba-2's gated-norm mean square) summed over ``model`` both ways
  (:func:`row_product` and :func:`copy_to_f32`, :func:`all_reduce_sum`);
  Zamba2's shared block at its wide config,
  its ``out_proj`` over this rank's rows; cross-attention over this
  rank's heads; the VLM projector's two column splits joined by
  :func:`gather_from`.
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


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        parts = [torch.empty_like(x) for _ in range(g.size)]
        dist.all_gather(parts, x.contiguous(), group=g.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.dim, ctx.g).contiguous(), None, None


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


def all_reduce_sum(x: torch.Tensor, *groups: Group) -> torch.Tensor:
    """``x`` summed over ``groups``, and its gradient summed over them
    too: a partial product that every rank of the group then reads for
    its own part (Mamba-2's gated-norm sum of squares), so each rank's
    gradient of the sum is partial as well.  Accumulated in f32, as
    :func:`reduce_from`."""
    return _AllReduce.apply(x, groups) if groups else x


def gather_from(x: torch.Tensor, g: Optional[Group],
                dim: int = -1) -> torch.Tensor:
    """Every rank's chunk of ``dim`` concatenated in rank order (the whole
    of a column-split output); the gradient keeps this rank's chunk, so
    the gradient that reaches the gathered tensor must be whole on every
    rank (put :func:`copy_to` after it where each rank uses the whole for
    its own part)."""
    if g is None:
        return x
    return _GatherFrom.apply(x, g, dim % x.dim())


# --------------------------------------------------------------------------
# Split products, summed in f32 and rounded once
# --------------------------------------------------------------------------
def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands of one dtype, its products summed in f32
    and not rounded: the GEMM's f32 output on the card (and on ``meta``),
    the upcast operands' product on the CPU (the same sums)."""
    if a.device.type != "cpu" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _RowProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        y = _mm_f32(x.reshape(-1, x.shape[-1]), w)  # this rank's own copy
        for g in groups:
            dist.all_reduce(y, group=g.group)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype).reshape(-1, grad.shape[-1])
        dx = torch.mm(g, w.t()).reshape(x.shape)
        return dx, torch.mm(x.reshape(-1, x.shape[-1]).t(), g), None


def row_product(x: torch.Tensor, w: torch.Tensor,
                *groups: Group) -> torch.Tensor:
    """``x @ w`` in f32, ``x``'s last dim and ``w``'s rows split over
    ``groups``: each rank's partial product summed in f32 over them, not
    rounded (the caller rounds once, as the one-device product rounds),
    with no copy past the product's own output.  Its backward is the
    operands' dtype's own matmul, as :func:`reduce_from`'s."""
    return _RowProduct.apply(x, w, groups)


class _ColumnProducts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype, groups, *ws):
        ctx.set_materialize_grads(False)
        xc, wcs = x.to(dtype), [w.to(dtype) for w in ws]
        ctx.save_for_backward(xc, *wcs)
        ctx.groups, ctx.dtypes = groups, (x.dtype, *(w.dtype for w in ws))
        return tuple(torch.matmul(xc, w) for w in wcs)

    @staticmethod
    def backward(ctx, *grads):
        xc, *ws = ctx.saved_tensors
        x2 = xc.reshape(-1, xc.shape[-1])
        dx, dws = None, []
        for i, (grad, w) in enumerate(zip(grads, ws)):
            if grad is None:
                dws.append(None)
                continue
            g = grad.reshape(-1, grad.shape[-1]).to(w.dtype)
            if ctx.needs_input_grad[0]:
                part = _mm_f32(g, w.t())
                dx = part if dx is None else dx.add_(part)
            dws.append(_mm_f32(x2.t(), g).to(ctx.dtypes[1 + i])
                       if ctx.needs_input_grad[3 + i] else None)
        if dx is not None:
            for grp in ctx.groups:  # this rank's own sum
                dist.all_reduce(dx, group=grp.group)
            dx = dx.reshape(xc.shape).to(ctx.dtypes[0])
        return (dx, None, None, *dws)


def column_products(x: torch.Tensor, ws, dtype: torch.dtype,
                    *groups: Group) -> tuple:
    """``x @ w`` for each ``w`` of ``ws`` (this rank's columns where
    ``groups`` split them), both operands cast to ``dtype``: the
    forward is that dtype's matmul, as ``dense_apply``'s.  The gradients
    stay in f32 up to their sums: ``x``'s is every product's input
    gradient summed in f32 over the products and ``groups`` (``x``
    enters the region as :func:`copy_to`'s does) and rounded once to
    ``x``'s dtype; each ``w``'s is rounded once to ``w``'s dtype (f32
    parameters keep the f32 sum, which the batch axes then sum)."""
    return _ColumnProducts.apply(x, dtype, groups, *ws)


class _CopyToF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, share):
        ctx.g, ctx.share, ctx.dtype = g, share, x.dtype
        return x.view_as(x) if x.dtype == torch.float32 else x.float()

    @staticmethod
    def backward(ctx, grad):
        y = grad.to(torch.float32, copy=True)
        dist.all_reduce(y, group=ctx.g.group)
        if ctx.share:
            y /= ctx.g.size
        return y.to(ctx.dtype), None, None


def copy_to_f32(x: torch.Tensor, g: Optional[Group],
                share: bool = False) -> torch.Tensor:
    """``x``'s values in f32, its gradient (f32, each rank's part) summed
    over ``g`` in f32 and rounded once to ``x``'s dtype: a whole
    tensor that every rank reads for its own part (Mamba-1's ``x_proj``
    output; MLA's latent and rope key, Mamba-2's B and C, read by this
    rank's heads), where rounding each rank's part before the sum would
    round twice.  With ``share`` the sum is divided by the group's size:
    ``x`` was computed alike on every rank from parameters whose
    gradients are summed over the group (``SPLIT``), so each rank
    carries its share of the whole into those sums.  ``x`` itself where
    ``g`` is None or no gradient is taken."""
    if g is None or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _CopyToF32.apply(x, g, share)


# --------------------------------------------------------------------------
# Which parameters tensor parallelism splits
# --------------------------------------------------------------------------
def attention_group(cfg) -> Optional[Group]:
    """The model group when a GQA attention runs over this rank's heads:
    the rules split heads over an axis of size M > 1, the effective KV
    heads (``n_kv_heads * kv_repeat``) divide M, and the cache is not
    placed by sequence (then every rank computes every head over its
    positions).  MLA has :func:`mla_group`."""
    g = logical_group("heads")
    if g is None or cfg.mla is not None or cfg.n_heads == 0 \
            or cfg.kv_cache_shard == "seq" \
            or (cfg.n_kv_heads * cfg.kv_repeat) % g.size:
        return None
    return g


def mla_group(cfg) -> Optional[Group]:
    """The model group when an MLA attention runs over this rank's heads:
    the rules split heads over an axis of size M > 1 that divides them.
    Every rank computes the whole latent and rope key (its cache is
    placed by batch only, ``cache_pspec``) and attends with its heads."""
    g = logical_group("heads")
    if g is None or cfg.mla is None or cfg.n_heads % g.size:
        return None
    return g


def vocab_group(vocab: int) -> Optional[Group]:
    """The model group when the vocabulary is split over this rank's rows
    of ``embed.table`` and columns of ``lm_head.w``: the rules map
    ``vocab`` to an axis of size M > 1 that divides ``vocab``, as
    ``param_pspec`` places them (internvl2's 92,553 and seamless' 256,206
    do not divide 16, and stay whole)."""
    g = logical_group("vocab")
    if g is None or vocab % g.size:
        return None
    return g


def vocab_argmax(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """``torch.argmax(x, -1)`` of the whole vocabulary from this rank's
    columns ``x`` [..., V/M] of it: each rank's largest value and its
    global index, gathered over ``g``, the first rank's where several
    hold the maximum (``torch.argmax`` keeps the first maximum)."""
    idx = torch.argmax(x, dim=-1)
    if g is None:
        return idx
    val = torch.take_along_dim(x, idx[..., None], dim=-1)[..., 0]
    idx = idx + g.rank * x.shape[-1]
    vals = [torch.empty_like(val) for _ in range(g.size)]
    idxs = [torch.empty_like(idx) for _ in range(g.size)]
    dist.all_gather(vals, val.contiguous(), group=g.group)
    dist.all_gather(idxs, idx.contiguous(), group=g.group)
    vals, idxs = torch.stack(vals), torch.stack(idxs)
    first = torch.argmax((vals == vals.amax(dim=0)).to(torch.int32), dim=0)
    return torch.take_along_dim(idxs, first[None], dim=0)[0]


def kv_split(cfg, g: Group) -> bool:
    """Under :func:`attention_group`, whether ``wk`` and ``wv`` are split
    by heads too (else every rank projects every KV head and keeps its
    own): without KV replication, KV heads that divide M, and no int8
    cache, whose per-row scales are replicated over the model axis."""
    return (cfg.kv_repeat == 1 and cfg.n_kv_heads % g.size == 0
            and not cfg.kv_cache_quant)


def mlp_group(d_ff: int) -> Optional[Group]:
    """The model group when the rules split ``ff`` over an axis of size
    M > 1 that divides ``d_ff``: the MLP's hidden width, or another width
    the reference places over ``model`` alike (the shared block's rows,
    the projector's columns)."""
    g = logical_group("ff")
    return g if g is not None and d_ff % g.size == 0 else None


def moe_group(cfg) -> Optional[Group]:
    """The reference's condition for ``_moe_tp_psum``: the experts' mesh
    axis has size > 1 and divides the routed experts."""
    g = logical_group("experts")
    return g if g is not None and cfg.moe.n_routed % g.size == 0 else None


def cross_group(cfg) -> Optional[Group]:
    """The model group when a decoder's cross-attention runs over this
    rank's heads: the rules split heads over an axis of size M > 1 that
    divides the query and the KV heads (it keeps no cache, so no cache
    placement enters)."""
    g = logical_group("heads")
    if g is None or cfg.n_heads % g.size or cfg.n_kv_heads % g.size:
        return None
    return g


def ssm_group(cfg) -> Optional[Group]:
    """The model group when a Mamba mixer runs over this rank's share of
    ``d_inner``: Mamba-1's channels, Mamba-2's heads (``headdim`` channels
    each), where the rules split ``ff`` over an axis of size M > 1 that
    divides their count.  None where M divides none of the widths the
    reference splits (it places every leaf whole, and the mixer runs
    whole); a ``ValueError`` naming the leaf where it would split some
    of them but not the channels or heads the mixer runs over."""
    g = logical_group("ff")
    if g is None:
        return None
    s = cfg.ssm
    di = s.expand * cfg.d_model
    if s.kind == "mamba1":
        count, leaf, width = di, "mamba.in_proj.w", 2 * di
    else:
        count, leaf, width = di // s.headdim, "mamba.in_x.w", di
    if count % g.size == 0:
        return g
    if width % g.size == 0:
        raise ValueError(
            f"{cfg.name}: {leaf} is placed over the {g.axis} axis of "
            f"{g.size}, but its mixer's {count} "
            f"{'channels' if s.kind == 'mamba1' else 'heads'} do not divide "
            f"it")
    return None


class Plan(NamedTuple):
    """How the model code consumes one parameter: ``kind`` (``FULL``,
    ``SHARD`` or ``SPLIT``), for ``SHARD`` the ``dim`` it takes this
    rank's chunk of (of each of ``parts`` equal parts, in order), and the
    ``group`` of the model axis (None for ``FULL``)."""

    kind: str
    dim: Optional[int] = None
    group: Optional[Group] = None
    parts: int = 1


_WHOLE = Plan(FULL)
_MLA = re.compile(
    r"^attn\.(wq|wq_a|q_a_norm|wq_b|wkv_a|kv_a_norm|wkv_b|wo)\.(w|scale)$")
#: MLA's leaves that hold this rank's heads -> the dim of them; the rest
#: (``wq_a``, ``q_a_norm``, ``wkv_a``, ``kv_a_norm``) are whole, and each
#: rank reads them for its own heads
_MLA_SHARD = {"wq": 1, "wq_b": 1, "wkv_b": 1, "wo": 0}
#: the vocabulary's leaves -> the dim of this rank's rows or columns
_VOCAB = {"embed.table": 0, "lm_head.w": 1}
_ATTN = re.compile(
    r"^(attn|cross)\.(wq|wk|wv|wo|q_norm|k_norm)\.(w|b|scale)$")
_MLP = re.compile(r"^(mlp|moe\.shared)\.(gate|up|down)\.w$")
_EXPERTS = re.compile(r"^moe\.(w_gate|w_up|w_down|router\.w)$")
_PROJECTOR = re.compile(r"^projector\.fc[12]\.(w|b)$")
_MAMBA = re.compile(r"^mamba\.(.+)$")
#: a Mamba leaf the reference places over ``model`` -> (the dim this
#: rank's chunk is taken of, parts); the mixer's other leaves (Mamba-2's
#: ``in_B``, ``in_C`` and their convs) are whole on every rank, each
#: reading them for its own heads
_MAMBA_SHARD = {
    "in_proj.w": (1, 2),  # [xin | z]: this rank's chunk of each half
    "conv_w": (1, 1), "conv_b": (0, 1), "x_proj.w": (0, 1),
    "dt_proj.w": (1, 1), "dt_proj.b": (0, 1), "A_log": (0, 1),
    "D": (0, 1), "out_proj.w": (0, 1),
    "in_z.w": (1, 1), "in_x.w": (1, 1), "in_dt.w": (1, 1),
    "conv_x_w": (1, 1), "conv_x_b": (0, 1), "norm.scale": (0, 1),
    "dt_bias": (0, 1),  # no rule: whole, this rank's heads taken out
}
#: the prefix of Zamba2's shared block, whose leaves :func:`plan` reads
#: under the block's wide config
SHARED = "shared_attn."


def plan(name: str, cfg) -> Plan:
    """The :class:`Plan` of the parameter ``name`` under ``cfg``, the
    config its module runs under: a layer's leaf (``attn.wq.w``,
    ``mlp.down.w``, ``moe.w_gate``, ``mamba.in_proj.w``, ``cross.wq.w``,
    ...) under the layer's config, Zamba2's shared block's
    (``shared_attn.attn.wq.w``, ``shared_attn.out_proj.w``, ...) under
    its wide config, the VLM projector's (``projector.fc1.w``) under the
    model's; ``embed.table`` and ``lm_head.w`` under the model's config.
    ``SHARD`` -- the code takes this rank's chunk of ``dim``
    over the group's axis; ``SPLIT`` -- it takes the whole, but each rank
    of the group uses it for its own part, so its gradient sums over the
    group; ``FULL`` (group None) -- the whole, used alike on every
    rank."""
    if name in _VOCAB:
        g = vocab_group(cfg.vocab)
        return Plan(SHARD, _VOCAB[name], g) if g is not None else _WHOLE
    if name.startswith(SHARED):
        name = name[len(SHARED):]
        if name == "out_proj.w":  # rows of the wide stream
            g = mlp_group(cfg.d_model)
            return Plan(SHARD, 0, g) if g is not None else _WHOLE
    m = _MLA.match(name) if cfg.mla is not None else None
    if m:
        g = mla_group(cfg)
        if g is None:
            return _WHOLE
        dim = _MLA_SHARD.get(m.group(1))
        return Plan(SPLIT, None, g) if dim is None else Plan(SHARD, dim, g)
    m = _ATTN.match(name)
    if m:
        where, proj, leaf = m.groups()
        g = attention_group(cfg) if where == "attn" else cross_group(cfg)
        if g is None:
            return _WHOLE
        dim = 1 if leaf == "w" else 0
        if proj == "wq":
            return Plan(SHARD, dim, g)
        if proj in ("wk", "wv"):
            return (Plan(SHARD, dim, g) if where == "cross"
                    or kv_split(cfg, g) else Plan(SPLIT, None, g))
        if proj == "wo":
            return Plan(SHARD, 0, g)
        return Plan(SPLIT, None, g)  # the per-head norms see this rank's heads
    m = _MLP.match(name)
    if m:
        d_ff = (cfg.d_ff if m.group(1) == "mlp"
                else cfg.moe.d_shared_ff * cfg.moe.n_shared)
        g = mlp_group(d_ff)
        if g is None:
            return _WHOLE
        return Plan(SHARD, 0 if m.group(2) == "down" else 1, g)
    m = _EXPERTS.match(name)
    if m:
        g = moe_group(cfg)
        if g is None:
            return _WHOLE
        # every rank routes all its tokens, but only its experts' outputs
        # carry the routing weights' gradient back to the router
        return (Plan(SPLIT, None, g) if m.group(1) == "router.w"
                else Plan(SHARD, 0, g))
    m = _MAMBA.match(name)
    if m:
        g = ssm_group(cfg)
        if g is None:
            return _WHOLE
        if m.group(1) in _MAMBA_SHARD:
            dim, parts = _MAMBA_SHARD[m.group(1)]
            return Plan(SHARD, dim, g, parts)
        return Plan(SPLIT, None, g)
    m = _PROJECTOR.match(name)
    if m:
        g = mlp_group(cfg.d_model)
        if g is None:
            return _WHOLE
        return Plan(SHARD, 1 if m.group(1) == "w" else 0, g)
    return _WHOLE


# --------------------------------------------------------------------------
# Parameters: DTensor -> the local tensor the code computes with
# --------------------------------------------------------------------------
def to_compute(p, kind: str = FULL, dim: Optional[int] = None,
               group: Optional[Group] = None,
               parts: int = 1) -> torch.Tensor:
    """The local tensor of the ``DTensor`` ``p`` that the code computes
    with (see :func:`plan`), differentiable back to ``p``.  A ``SHARD``
    chunk that is not the block ``p`` holds (``p`` placed whole over the
    group's axis, or a chunk of each of ``parts`` parts) is taken from
    the gathered whole, whose gradient then sums over the group."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = current_mesh()
    dm = mesh.device_mesh
    batch = batch_axes()
    target, grads, kept = [], [], False
    for axis, pl in zip(dm.mesh_dim_names, p.placements):
        keep = (kind == SHARD and group is not None and axis == group.axis
                and pl == Shard(dim) and parts == 1)
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
        t = local_slice(t, dim, group, parts)
    return t


@contextlib.contextmanager
def local_params(module: torch.nn.Module, cfg=None, *, skip=(),
                 prefix: str = ""):
    """For the length of the block, each ``DTensor`` parameter of
    ``module`` (but those under the child modules named in ``skip``) is
    replaced by its local compute tensor: as :func:`plan` says for the
    parameter's name (after ``prefix``) under ``cfg``, the config the
    module runs under, or whole when ``cfg`` is None; a plain parameter
    that the plan splits is replaced by this rank's chunk.  A no-op
    without an installed mesh."""
    if _device_mesh() is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    swapped = []
    for path, sub in module.named_modules():
        if path.split(".")[0] in skip:
            continue
        for leaf, p in list(sub._parameters.items()):
            if p is None:
                continue
            name = prefix + (f"{path}.{leaf}" if path else leaf)
            how = plan(name, cfg) if cfg is not None else _WHOLE
            if isinstance(p, DTensor):
                sub._parameters[leaf] = to_compute(p, *how)
            elif how.kind == SHARD:  # a whole tensor on every rank
                sub._parameters[leaf] = local_slice(p, how.dim, how.group,
                                                    how.parts)
            else:
                continue
            swapped.append((sub, leaf, p))
    try:
        yield
    finally:
        for sub, leaf, p in swapped:
            sub._parameters[leaf] = p


def local_slice(t: torch.Tensor, dim: int, g: Group,
                parts: int = 1) -> torch.Tensor:
    """This rank's chunk of ``dim`` of a tensor every rank holds whole (a
    layer built without ``shard_model``, or a gathered parameter): of
    each of ``parts`` equal parts of ``dim``, concatenated in order."""
    n = t.shape[dim] // parts
    c = n // g.size
    if parts == 1:
        return t.narrow(dim, g.rank * c, c)
    return torch.cat([t.narrow(dim, i * n + g.rank * c, c)
                      for i in range(parts)], dim=dim)
