"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch.

Counterpart of the reference's ``models/moe.py``, its ``local`` schedule:
one device holds every expert and runs the whole dispatch.  The
reference's ``tp_psum`` schedule (``_moe_tp_psum``: experts sharded over
a mesh axis with ``shard_map``, partial outputs summed with ``psum``) has
no meaning on one card; it comes with sharding (ROADMAP, queue 1 item 9).
``moe_ffn_local`` keeps its ``expert_slice`` argument, so a caller can
compute one shard's partial output, as the reference's ``shard_fn`` does.
The reference's ``_aux_load_balance_loss`` has no caller there and is not
ported.

The semantics are the reference's, step for step:

- router logits in f32; softmax over the experts, then the top k
  (descending, the lower expert first among equal gates, as
  ``jax.lax.top_k``), renormalised by ``max(sum, 1e-9)``;
- each (token, slot) assignment's arrival position within its expert,
  row-major over (T, k) (a cumulative sum of one-hot rows);
- ``cap = max(ceil(top_k * T * capacity_factor / n_routed), 1)`` in the
  same float arithmetic; an assignment at or past ``cap`` is dropped;
- the kept tokens go into per-expert buffers ``[E, cap, d]``, the expert
  GEMMs ``silu(x W_gate) * (x W_up)`` then ``W_down`` run as batched
  matrix products in the compute dtype, and each kept (token, slot)
  reads its row back;
- the combine over the k slots is in f32, cast to the compute dtype;
  shared experts, if any, are added after.

The scatter writes only kept assignments, whose (expert, position) pairs
are unique, so it needs no atomics and is deterministic; a dropped
assignment goes to a spare row past the buffers, which is zero when the
combine reads it.  Nothing here waits on the device: no count leaves the
card.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import (MLP, Dense, _normal, dense_apply,
                                       mlp_apply, torch_dtype)


class MoE(nn.Module):
    """Router ``[d, E]``, stacked expert weights ``w_gate``, ``w_up``
    ``[E, d, ff]`` and ``w_down`` ``[E, ff, d]`` (``init_moe``), and the
    optional shared experts, one MLP of width ``d_shared_ff * n_shared``."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m: MoEConfig = cfg.moe
        d, dt = cfg.d_model, cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.router = Dense(d, m.n_routed, **kw)

        def experts(shape, scale):
            return nn.Parameter(_normal(shape, scale=scale, **kw),
                                requires_grad=False)

        scale = 1.0 / math.sqrt(d)
        self.w_gate = experts((m.n_routed, d, m.d_expert_ff), scale)
        self.w_up = experts((m.n_routed, d, m.d_expert_ff), scale)
        self.w_down = experts((m.n_routed, m.d_expert_ff, d),
                              1.0 / math.sqrt(m.d_expert_ff))
        self.shared = (MLP(d, m.d_shared_ff * m.n_shared, **kw)
                       if m.n_shared else None)


# --------------------------------------------------------------------------
# Routing and dispatch bookkeeping
# --------------------------------------------------------------------------
def _topk_routing(router_logits: torch.Tensor, top_k: int):
    """Returns (weights [T,k] f32, idx [T,k] int64), the weights
    renormalised over the top k.  A stable descending sort keeps the lower
    expert first among equal gates, as ``jax.lax.top_k`` does."""
    gates = torch.softmax(router_logits.float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals, idx


def _positions_in_expert(idx: torch.Tensor, n_expert: int) -> torch.Tensor:
    """idx: [T, k] expert assignment.  Returns pos [T, k]: arrival order of
    each assignment within its expert (row-major over (T, k))."""
    T, k = idx.shape
    flat = idx.reshape(T * k)
    # the one-hot laid out [E, T*k], so the running count is a scan along
    # the inner dim (a CUDA scan along the outer dim walks it serially);
    # built by comparison, since F.one_hot checks its bounds with a sync
    experts = torch.arange(n_expert, device=idx.device)
    onehot = (experts[:, None] == flat[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.take_along_dim(pos, flat[None, :], dim=0)[0]
    return pos.reshape(T, k).long()


def capacity(m: MoEConfig, n_tokens: int) -> int:
    """Rows per expert buffer for ``n_tokens`` tokens (the reference's
    float arithmetic, at least 1)."""
    return max(int(np.ceil(m.top_k * n_tokens * m.capacity_factor
                           / m.n_routed)), 1)


def route(logits: torch.Tensor, cfg: ArchConfig, *,
          expert_slice: Optional[tuple[int, int]] = None) -> dict:
    """The dispatch plan of T tokens from their router logits [T, E]:
    ``weights``, ``idx``, ``pos`` [T, k], ``cap``, ``keep`` [T, k] (in this
    shard's experts and under the capacity) and ``slot`` [T*k], each
    assignment's row in the flattened ``[E_loc * cap]`` buffers (the spare
    row ``E_loc * cap`` where dropped)."""
    m: MoEConfig = cfg.moe
    T = logits.shape[0]
    weights, idx = _topk_routing(logits, m.top_k)
    pos = _positions_in_expert(idx, m.n_routed)
    cap = capacity(m, T)
    e_start, e_count = (expert_slice if expert_slice is not None
                        else (0, m.n_routed))
    local_e = idx - e_start
    keep = (local_e >= 0) & (local_e < e_count) & (pos < cap)
    slot = torch.where(keep, local_e * cap + pos,
                       torch.full_like(pos, e_count * cap)).reshape(-1)
    return dict(weights=weights, idx=idx, pos=pos, cap=cap, keep=keep,
                slot=slot, n_experts=e_count)


def dispatch(x: torch.Tensor, plan: dict, cd: torch.dtype) -> torch.Tensor:
    """The kept tokens scattered into per-expert buffers [E_loc, cap, d]
    in the compute dtype; rows no assignment reaches stay zero.  The
    scatter is done on token ids: each buffer row learns which token it
    holds (the zero row ``T`` if none), then one gather fills the
    buffers, so no [T*k, d] copy of the tokens is made."""
    T, d = x.shape
    k = plan["idx"].shape[1]
    rows = plan["n_experts"] * plan["cap"]
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    src = torch.full((rows + 1,), T, dtype=torch.long, device=x.device)
    src.index_put_((plan["slot"],), token)  # kept slots are unique
    x_pad = torch.cat([x.to(cd), x.new_zeros((1, d), dtype=cd)])
    buf = x_pad.index_select(0, src[:rows])
    return buf.reshape(plan["n_experts"], plan["cap"], d)


def experts_apply(p, buf: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """The expert GEMMs on [E, C, d] buffers: ``silu(g) * u``, then the
    down projection, batched matrix products in the compute dtype."""
    g = torch.bmm(buf, p.w_gate.to(cd))
    u = torch.bmm(buf, p.w_up.to(cd))
    h = torch.nn.functional.silu(g) * u
    return torch.bmm(h, p.w_down.to(cd))


def combine(out_buf: torch.Tensor, plan: dict, cd: torch.dtype
            ) -> torch.Tensor:
    """Each kept (token, slot) reads its (expert, position) row, a dropped
    one the zero row past the buffers; the rows are summed over the slots
    with the routing weights in f32."""
    T, k = plan["idx"].shape
    d = out_buf.shape[-1]
    flat = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    gathered = flat.index_select(0, plan["slot"]).reshape(T, k, d).float()
    out = torch.einsum("tkd,tk->td", gathered, plan["weights"].float())
    return out.to(cd)


# --------------------------------------------------------------------------
# Local (per-shard) dispatch + expert compute
# --------------------------------------------------------------------------
def moe_ffn_local(p, x: torch.Tensor, cfg: ArchConfig, *,
                  expert_slice: Optional[tuple[int, int]] = None
                  ) -> torch.Tensor:
    """x: [T, d] tokens.  Computes the routed-expert output.

    ``expert_slice=(start, count)``: only experts in [start, start+count)
    are computed (partial outputs of the shards sum to the whole).  The
    expert weights of ``p`` are then the *local* slice, as in the
    reference; the router stays whole."""
    cd = torch_dtype(cfg.compute_dtype)
    logits = dense_apply(p.router, x, torch.float32)  # router in fp32
    plan = route(logits, cfg, expert_slice=expert_slice)
    out_buf = experts_apply(p, dispatch(x, plan, cd), cd)
    return combine(out_buf, plan, cd)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  Routed experts + optional shared
    experts."""
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    out = moe_ffn_local(p, x.reshape(B * S, d), cfg).reshape(B, S, d)
    if m.n_shared:
        out = out + mlp_apply(p.shared, x, cfg.compute_dtype)
    return out
