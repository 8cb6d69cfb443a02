"""Ring attention: sequence-parallel exact attention.

Counterpart of the reference's ``distributed/ring_attention.py``.  Q, K
and V are sequence-sharded over the ring's mesh axis (and the batch over
the data axes).  Each rank keeps its block of queries; K and V rotate one
hop per step around the axis (``batch_isend_irecv`` to the next rank,
from the previous one: after step i a rank holds the block of rank
``idx - i``), and the blocks merge by their row logsumexp.  Per-rank wire
bytes are (n-1)/n * |KV|, as the reference's ``ppermute`` moves.

Each block's attention is the port's ``flash_attention`` kernel with its
row logsumexp (``flash_attention_lse_op``: the CUDA kernel on a card, its
plain version on the CPU), causal on the diagonal block and unmasked
below it; a block wholly above the diagonal (causal, ``src > idx``) has
weight exactly 0 in the reference's merge, so its attention is skipped,
while its K and V still travel on.  :func:`ring_step` is one block's
work and merge, the same function the distributed loop and a one-device
drive over n blocks call.  :func:`ring_attention_ref` is the plain
one-device oracle, the reference's ``_local_block`` math.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.ctx import P
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.kernels.flash_attention.ops import flash_attention_lse_op

NEG_INF = -1e30


def _local_block(q, k, v, q_pos, kv_pos, causal, scale):
    """q: [B,Sq,KV,G,D]; k,v: [B,Skv,KV,D] -> (scores-weighted acc, m, l)."""
    s = torch.einsum("bqkgd,bpkd->bkgqp", q.float(), k.float()) * scale
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)  # [B,KV,G,Sq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqp,bpkd->bqkgd", p, v.float())
    return acc, m, l


def ring_attention_ref(q, k, v, *, causal: bool = True):
    """Single-device oracle (same math as models.attention naive path)."""
    B, S, KVH, G, D = q.shape
    pos = torch.arange(S, device=q.device)
    acc, m, l = _local_block(q, k, v, pos, pos, causal, 1.0 / math.sqrt(D))
    l = torch.clamp(l, min=1e-30)
    return (acc / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype)


def ring_step(carry: Optional[tuple], q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, *, causal: bool) -> tuple:
    """One block of the ring: the attention of the local queries q
    [B, KV*G, s, D] (GQA head order, query head ``kv*G + g`` reading KV
    head ``kv``) over one block of keys k, v [B, KV, s', D], through the
    kernel with its row logsumexp, merged into ``carry`` = (o f32
    [B, KV*G, s, D], lse f32 [B, KV*G, s]) or started when it is None."""
    o_b, lse_b = flash_attention_lse_op(q, k, v, causal=causal)
    o_b = o_b.float()
    if carry is None:
        return o_b, lse_b
    o, lse = carry
    new = torch.logaddexp(lse, lse_b)
    o = (o * torch.exp(lse - new)[..., None]
         + o_b * torch.exp(lse_b - new)[..., None])
    return o, new


def _local(x, sharding: NamedSharding) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        x = sharding.distribute(x)
    return x.redistribute(sharding.mesh.device_mesh,
                          sharding.placements).to_local()


def ring_attention(q, k, v, *, mesh, axis: str = "model",
                   causal: bool = True, dp_axes=("data",)):
    """q: [B, S, KV, G, D]; k, v: [B, S, KV, D]; S sharded over `axis`.

    ``mesh`` is built over ranks (``launch.mesh.init_mesh``); q, k and v
    are DTensors (or whole tensors, the same on every rank) and are placed
    as the reference's ``q_spec`` / ``kv_spec``.  Returns a DTensor
    [B, S, KV, G, D] placed as q.
    """
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh
    n = mesh.shape[axis]
    B, S, KVH, G, D = q.shape
    dp = tuple(a for a in dp_axes if a in mesh.axis_names) or None
    q_spec = NamedSharding(mesh, P(dp, axis, None, None, None))
    kv_spec = NamedSharding(mesh, P(dp, axis, None, None))
    ql, kl, vl = _local(q, q_spec), _local(k, kv_spec), _local(v, kv_spec)

    idx = dm.get_local_rank(axis)
    group = dm.get_group(axis)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    b, s = ql.shape[:2]
    qh = ql.permute(0, 2, 3, 1, 4).reshape(b, KVH * G, s, D).contiguous()
    kb = kl.transpose(1, 2).contiguous()
    vb = vl.transpose(1, 2).contiguous()
    carry = None
    for i in range(n):
        src = (idx - i) % n  # whose KV block we currently hold
        reqs = []
        if i < n - 1:  # rotate KV one hop around the ring
            kn, vn = torch.empty_like(kb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kb, nxt, group),
                dist.P2POp(dist.isend, vb, nxt, group),
                dist.P2POp(dist.irecv, kn, prv, group),
                dist.P2POp(dist.irecv, vn, prv, group)])
        if not (causal and src > idx):
            carry = ring_step(carry, qh, kb, vb, causal=causal and src == idx)
        for r in reqs:
            r.wait()
        if reqs:
            kb, vb = kn, vn
    out = carry[0].reshape(b, KVH, G, s, D).permute(0, 3, 1, 2, 4)
    out = out.to(q.dtype).contiguous()
    return DTensor.from_local(out, dm, q_spec.placements, shape=q.shape,
                              stride=out.new_empty(q.shape,
                                                   device="meta").stride())
