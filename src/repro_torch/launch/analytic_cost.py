"""FLOP count of a step by a walk of what it dispatches, its memory on
the ``meta`` device, and an HBM-traffic model for the roofline's memory
term.

Counterpart of the reference's ``launch/analytic_cost.py``.  The
reference walks the step's jaxpr; a torch step is no program to walk, so
:func:`count_flops` runs it under a ``TorchDispatchMode``
(:class:`StepCount`) and sums every product the step dispatches, with the
reference's ``2·M·N·K`` convention (``_dot_flops``): ``aten.mm``,
``addmm``, ``bmm`` and ``baddbmm`` (``einsum``, ``matmul`` and ``linear``
reach the dispatcher as these), ``mv`` and ``dot``; and convolutions, at
2 · output elements · kernel elements per output (``_conv_flops``), a
convolution's backward at that once for each gradient it computes.
Elementwise work, reductions and copies count nothing, as in the
reference.  Run on tensors of the ``meta`` device
(``zoo.init_model(cfg, device="meta")``, ``zoo.input_specs``), the walk
allocates and computes nothing.  Remat's recompute is counted, because
``torch.utils.checkpoint`` replays the forward inside the walk (the
reference counts it because its walk runs on the differentiated program).

**The attention kernels are charged by the reference's rule, not by their
own tiles**, so the count is the same whatever implements them: the CUDA
kernels, their plain versions on the CPU, the empty outputs of ``meta``, or
a later kernel with other tiles.  The walk cannot see into a ``ctypes``
launch, so each call is charged where it is applied: while a count is
open, ``flash_attention_op`` applies :class:`ChargedFlashAttentionFn` in
``FlashAttentionFn``'s place (the serving call is untouched when no count
is open), and nothing that runs inside it counts.  For q [B, H, Sq, Dqk],
k [B, KV, Skv, Dqk] and v [B, KV, Skv, Dv], at the count's tiling (the
step's config's ``q_chunk``, ``kv_chunk`` and ``attention_impl``,
:func:`tiling_of`, which every attention call of the reference passes:
its cross-attention names ``chunked`` instead, which charges a call that
is not causal alike), the forward is charged what the reference's
``_chunked_attention`` (``models/attention.py:87``) counts
(:func:`attention_flops`)::

    qc = min(q_chunk, Sq),  kc = min(kv_chunk, Skv)
    blocks = sum over q chunks i < Sq / qc of
               min(Skv / kc, ((i + 1)·qc - 1) // kc + 1)  causal "chunked", Sq == Skv
               Skv / kc                                    otherwise
    forward = blocks · 2·B·H·qc·kc·(Dqk + Dv)

or 2·B·H·Sq·Skv·(Dqk + Dv) where the reference's ``grouped_attention``
takes its naive path instead (Sq not a multiple of qc, or Skv of kc).
The backward is charged twice the forward: what ``jax.grad`` of that
forward counts (dS·k, dSᵀ·q, dO·vᵀ and Pᵀ·dO for the two products).

Collectives (:class:`StepCount`'s ``collective_ops``): every ``c10d``
and ``_c10d_functional`` op the step dispatches (the port's own
``dist.all_reduce`` / ``all_gather`` and DTensor's ``redistribute``, on
a real group or a ``fake`` one: ``launch/mesh.py::fake_world``) is logged
as (the reference's kind, the group's size, the bytes of its result
buffer), before the ``meta`` answer of a repeated call
(:func:`_meta_call`) could hide it.  ``wait_tensor`` and
``_wrap_tensor_autograd`` are not collectives.  Point-to-point traffic
never reaches the dispatcher on ``meta`` (the ``fake`` backend has no
``meta`` device for ``isend`` / ``irecv``), so the ring's exchange
(``distributed/ring_attention.py::_exchange``) hands its ops to
:func:`count_p2p`: each receive is a ``collective-permute`` of its buffer
(as the reference's ``ppermute``), and an exchange of ``meta`` tensors is
skipped.
``launch/roofline.py::collective_bytes_from_ops`` sums the log in the
dict shape of ``collective_bytes_from_hlo``.

Memory (:class:`StepCount`'s ``peak_bytes``): the walk follows every
storage the step's own ops allocate, from its allocation until the last
tensor on it is freed, and keeps the peak of their sum.  That is the peak
of the step's live temporaries, its outputs included (a prefill's new
caches, a train step's gradients); the dry run adds the exact bytes of
the step's arguments.  The caching allocator's rounding and a kernel's
own workspace are not in it.
"""
from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn

aten = torch.ops.aten

#: the reference's ``grouped_attention`` tiling defaults: (q_chunk,
#: kv_chunk, attention_impl), the charge of a count that names none
DEFAULT_TILING = (512, 512, "chunked")


def tiling_of(cfg) -> tuple:
    """The reference's tiling of a config's attention calls."""
    return (cfg.q_chunk, cfg.kv_chunk, cfg.attention_impl)


def _prod(xs) -> float:
    out = 1.0
    for x in xs:
        out *= x
    return out


def attention_flops(q_shape, k_shape, v_shape, *, causal: bool,
                    tiling=DEFAULT_TILING) -> float:
    """The forward charge of one attention call (module docstring): what
    the reference's ``grouped_attention`` counts for it at ``tiling``
    ``(q_chunk, kv_chunk, attention_impl)``."""
    q_chunk, kv_chunk, impl = tiling
    B, H, Sq, Dqk = q_shape
    Skv, Dv = k_shape[2], v_shape[3]
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    unit = 2.0 * B * H * (Dqk + Dv)
    if impl == "naive" or Sq == 1 or Sq % qc or Skv % kc:
        return unit * Sq * Skv
    nq, nkv = Sq // qc, Skv // kc
    if causal and impl == "chunked" and Sq == Skv:
        blocks = sum(min(nkv, ((i + 1) * qc - 1) // kc + 1)
                     for i in range(nq))
    else:
        blocks = nq * nkv
    return unit * blocks * qc * kc


def _mm(args, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(args, out) -> float:
    return _mm(args[1:], out)


def _bmm(args, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(args, out) -> float:
    return _bmm(args[1:], out)


def _conv(args, out) -> float:
    # torch's weight is [C_out, C_in / groups, *k] ([C_in, C_out / groups,
    # *k] transposed): an output (input, transposed) element takes
    # prod(w.shape[1:]) multiply-adds
    x, w, transposed = args[0], args[1], bool(args[6])
    return 2.0 * (x.numel() if transposed else out.numel()) * _prod(
        w.shape[1:])


def _conv_backward(args, out) -> float:
    grad_out, x, w = args[0], args[1], args[2]
    transposed, mask = bool(args[7]), args[10]
    n = x.numel() if transposed else grad_out.numel()
    return 2.0 * n * _prod(w.shape[1:]) * (int(mask[0]) + int(mask[1]))


#: the products a walk counts, by op: FLOPs of a call
_PRODUCTS = {
    aten.mm: _mm, aten.addmm: _addmm, aten.addmm_: _addmm, aten.bmm: _bmm,
    aten.baddbmm: _baddbmm, aten.baddbmm_: _baddbmm,
    aten.mv: lambda args, out: 2.0 * args[0].shape[0] * args[0].shape[1],
    aten.dot: lambda args, out: 2.0 * args[0].shape[0],
    aten.convolution: _conv, aten._convolution: _conv,
    aten.convolution_backward: _conv_backward,
}


def _product_flops(func, args, out) -> float:
    """FLOPs of one dispatched op (0 for every op that is no product)."""
    f = _PRODUCTS.get(func.overloadpacket)
    return f(args, out) if f is not None else 0.0


#: output metadata of the ``meta`` calls seen: (op, the inputs' shapes,
#: strides, dtypes and the other arguments) -> the outputs' tree, each
#: tensor as (shape, stride, dtype)
_META_OUT: dict = {}


#: op -> whether it returns new storage only (:func:`_fresh`)
_FRESH: dict = {}


def _fresh(func) -> bool:
    """Whether ``func`` returns new tensors only: its schema lets no output
    alias an input and no argument be written (an op that does alias one
    without saying so, as ``_unsafe_view``, is struck off at its first
    call: :func:`_meta_call`)."""
    got = _FRESH.get(func)
    if got is None:
        schema = func._schema
        got = _FRESH[func] = bool(schema.returns) and not (
            any(r.alias_info for r in schema.returns)
            or any(a.alias_info is not None and a.alias_info.is_write
                   for a in schema.arguments))
    return got


def _leaves(args, kwargs) -> list:
    """The arguments of a dispatched op, lists and tuples opened (an op's
    arguments nest no deeper)."""
    out = []
    for x in (*args, *kwargs.values()):
        if isinstance(x, (list, tuple)):
            out.extend(x)
        else:
            out.append(x)
    return out


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


#: the tensor types whose ``meta`` outputs are their metadata alone
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _meta_key(func, leaves, kwargs):
    key = [func, tuple(kwargs)]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta" or type(x) not in _PLAIN:
                return None  # a subclass (a DTensor) has more than metadata
            key.append((x.shape, x.stride(), x.dtype, x.storage_offset()))
        elif isinstance(x, _SCALARS):
            key.append(x)
        else:
            return None
    return tuple(key)


def _meta_call(func, args, kwargs, leaves):
    """``func(*args, **kwargs)`` for an op that returns new tensors.  On
    the ``meta`` device, where an output is a function of the inputs'
    metadata alone, a call is answered from the outputs' metadata of its
    first call with the same inputs (``torch.empty_strided``): PyTorch
    computes many ``meta`` outputs in Python, which would make a walk of a
    full-width step take minutes."""
    key = _meta_key(func, leaves, kwargs)
    spec = None if key is None else _META_OUT.get(key)
    if spec is not None:
        flat, tree = spec
        return tree_unflatten([torch.empty_strided(shape, stride,
                                                   dtype=dtype, device="meta")
                               for shape, stride, dtype in flat], tree)
    out = func(*args, **kwargs)
    flat, tree = tree_flatten(out)
    storages = {id(t.untyped_storage()) for t in leaves
                if isinstance(t, torch.Tensor)}
    if any(isinstance(t, torch.Tensor) and id(t.untyped_storage()) in
           storages for t in flat):  # aliases an input after all
        _FRESH[func] = False
    elif key is not None and all(type(t) in _PLAIN and
                                 t.device.type == "meta" for t in flat):
        _META_OUT[key] = ([(t.shape, t.stride(), t.dtype) for t in flat],
                          tree)
    return out


#: the collective ops a count logs -> the reference's kind (the others of
#: the two namespaces, ``wait_tensor`` and ``_wrap_tensor_autograd`` among
#: them, move nothing of their own)
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def _group_size(func, args) -> int:
    """The size of the process group a collective op names: a boxed
    ``ProcessGroup`` (``c10d``) or its ``group_name``
    (``_c10d_functional``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for spec, a in zip(func._schema.arguments, args):
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).size()
        if spec.name == "group_name":
            return _resolve_process_group(a).size()
    raise ValueError(f"{func}: a collective op without a process group")


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _collective(func, args, out):
    """(kind, group size, result bytes) of a collective op, or None: the
    result buffer is the output of a functional op and the first argument
    of an in-place ``c10d`` one (the tensors reduced in place, the
    gathered or scattered outputs)."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    kind = _COLLECTIVES.get(func.overloadpacket.__name__)
    if kind is None:
        return None
    result = out if func.namespace == "_c10d_functional" else args[0]
    return kind, _group_size(func, args), _tensor_bytes(result)


#: the counts open, the innermost last
_OPEN: list = []


def count_p2p(p2p_op_list) -> bool:
    """Log the receives of a ``batch_isend_irecv`` list to the innermost
    open count, each a ``collective-permute`` of its buffer; whether a
    count is open and the list holds ``meta`` tensors, which no backend
    carries (the caller then skips the exchange)."""
    import torch.distributed as dist

    if not _OPEN:
        return False
    meta = False
    for op in p2p_op_list:
        meta = meta or op.tensor.device.type == "meta"
        if op.op in (dist.irecv, dist.recv):
            group = op.group if op.group is not None else \
                dist.distributed_c10d._get_default_group()
            _OPEN[-1].collective_ops.append((
                "collective-permute", group.size(), _tensor_bytes(op.tensor)))
    return meta


class ChargedFlashAttentionFn(FlashAttentionFn):
    """``FlashAttentionFn`` while a count is open: the innermost count is
    charged the forward, and the backward, by the reference's rule
    (:meth:`StepCount.charge_attention`), and nothing that runs inside
    counts."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, save: bool):
        ctx.charge = (q.shape, k.shape, v.shape, causal)
        with _OPEN[-1].charge_attention(*ctx.charge):
            return FlashAttentionFn.forward(ctx, q, k, v, causal, save)

    @staticmethod
    def backward(ctx, dout):
        if not _OPEN:  # the backward of a call counted earlier
            return FlashAttentionFn.backward(ctx, dout)
        with _OPEN[-1].charge_attention(*ctx.charge, backward=True):
            return FlashAttentionFn.backward(ctx, dout)


class StepCount(TorchDispatchMode):
    """A walk of what a step dispatches: ``flops`` (module docstring),
    ``peak_bytes`` and ``live_bytes`` of the storages its ops allocate.
    ``tiling`` is the reference's chunking of the step's attention calls
    (:func:`tiling_of` its config).  ``collective_ops`` logs each
    collective (module docstring).  A count is the process's while it is
    open: an attention call of another thread is charged to it too.

        with StepCount(tiling_of(cfg)) as count:
            step(*args)
        count.flops, count.peak_bytes, count.collective_ops
    """

    def __init__(self, tiling=DEFAULT_TILING):
        super().__init__()
        self.tiling = tuple(tiling)
        self.flops = 0.0
        self.attention_flops = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.collective_ops: list[tuple] = []  # (kind, group size, bytes)
        self._inside = 0  # > 0 inside a charged attention call
        self._live: dict[int, tuple] = {}  # id(storage) -> (bytes, ref)

    def __enter__(self):
        if not _OPEN:
            self._displaced = flash_ops.FlashAttentionFn
            flash_ops.FlashAttentionFn = ChargedFlashAttentionFn
        _OPEN.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _OPEN.remove(self)
        if not _OPEN:
            flash_ops.FlashAttentionFn = self._displaced
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def charge_attention(self, q_shape, k_shape, v_shape, causal: bool, *,
                         backward: bool = False):
        """Charge one ``FlashAttentionFn`` call by the reference's rule at
        the count's tiling (twice the forward for a backward); nothing
        dispatched inside the context counts."""
        f = attention_flops(q_shape, k_shape, v_shape, causal=causal,
                            tiling=self.tiling) * (2.0 if backward else 1.0)
        self.flops += f
        self.attention_flops += f
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, (0,))[0]

    def _track(self, out) -> None:
        """Count the new storages of a fresh op's outputs as live until
        they are freed."""
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            key = id(s)
            if key in self._live:
                continue
            n = s.nbytes()
            self._live[key] = (n, weakref.ref(
                s, lambda _, key=key: self._freed(key)))
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fresh = _fresh(func)  # else a view or an in-place op: nothing new
        out = (_meta_call(func, args, kwargs, _leaves(args, kwargs))
               if fresh else func(*args, **kwargs))
        coll = _collective(func, args, out)
        if coll is not None:  # logged whether or not the cache answered
            self.collective_ops.append(coll)
        if not self._inside:
            self.flops += _product_flops(func, args, out)
        if fresh and _FRESH[func]:
            self._track(out)
        return out


def count_flops(fn, *args, tiling=DEFAULT_TILING) -> float:
    """Global FLOPs of ``fn(*args)`` (module docstring), its attention
    calls charged at ``tiling`` (:func:`tiling_of` the step's config):
    ``args`` on the ``meta`` device compute nothing; on a card or the CPU
    the step runs."""
    with StepCount(tiling) as count:
        fn(*args)
    return count.flops


# ==========================================================================
# HBM traffic model (per chip, per step)
# ==========================================================================
def hbm_bytes_per_chip(cfg, shape, mesh, *, mode: str, microbatches: int = 1,
                       param_count: int | None = None,
                       cache_bytes_total: float = 0.0) -> dict:
    """Structured napkin model of per-chip HBM traffic for one step.

    Counted flows (bf16 compute stream assumed):
    - weight streaming: every chip reads its TP shard of every weight once
      per (micro)batch pass; backward reads them again.
    - optimizer: fp32 param/m/v read + write on the FSDP shard (train only).
    - activations: residual-stream read+write at every layer boundary
      (sequence-sharded where applicable) times remat's extra forward.
    - attention score streaming for train/prefill (chunked online softmax:
      q,k,v read + out write per kv-chunk sweep — scores never hit HBM).
    - KV cache read (decode) / write (prefill).
    """
    chips = float(np.prod(list(mesh.shape.values())))
    tp = float(mesh.shape.get("model", 1))
    dp = chips / tp
    n = float(param_count if param_count is not None else cfg.param_count())
    B, S = shape.global_batch, shape.seq_len
    b_loc = max(B / dp, 1.0)
    L = cfg.n_layers + cfg.enc_layers
    d = cfg.d_model
    seq_fac = tp if S % tp == 0 else 1.0

    flows: dict[str, float] = {}
    w_shard = n * 2.0 / tp  # bf16 weights per chip after FSDP gather
    if mode == "train":
        # fwd + bwd weight reads, (1 + remat extra fwd) per microbatch
        flows["weights"] = w_shard * 3.0 * microbatches
        flows["optimizer"] = (n / chips) * 4.0 * (3 + 3)  # rw p,m,v fp32 (FSDP shard)
        flows["grads"] = (n / chips) * 4.0 * 2.0
        act = b_loc * S * d * 2.0 / seq_fac
        flows["activations"] = act * L * 2.0 * 2.0  # rw x (fwd + recompute)
        if not cfg.is_attention_free and cfg.n_heads:
            kv_bytes = b_loc * S * cfg.n_kv_heads * cfg.head_dim * 2.0 / tp
            sweeps = max(S / max(cfg.kv_chunk, 1), 1.0) / 2.0  # causal skip
            flows["attention_kv_stream"] = kv_bytes * sweeps * L * 3.0  # fwd+bwd
    elif mode == "prefill":
        flows["weights"] = w_shard
        act = b_loc * S * d * 2.0 / seq_fac
        flows["activations"] = act * L * 2.0
        flows["kv_cache_write"] = cache_bytes_total / chips
        if not cfg.is_attention_free and cfg.n_heads:
            kv_bytes = b_loc * S * cfg.n_kv_heads * cfg.head_dim * 2.0 / tp
            sweeps = max(S / max(cfg.kv_chunk, 1), 1.0) / 2.0
            flows["attention_kv_stream"] = kv_bytes * sweeps * L
    else:  # decode
        flows["weights"] = w_shard
        flows["kv_cache_read"] = cache_bytes_total / chips
        flows["activations"] = b_loc * d * 2.0 * L * 2.0
    flows["total"] = float(sum(flows.values()))
    return flows
