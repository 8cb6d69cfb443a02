"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of the reference's ``train/optimizer.py``, with the same
numerics: the update in f32, bias correction with the step as f32, weight
decay on leaves with ``ndim >= 2`` only, the gradient norm reported before
the clip.  Params, gradients and the moments are dicts keyed by the
model's ``state_dict`` names (``dict(model.named_parameters())``), and the
state is ``{"m", "v", "step"[, "master"]}``.

The reference's arrays are immutable and its update returns new ones.
Here the update writes in place: the params (so the model's own
parameters move), and the moments and the master copy in the state.

A leaf of more than :data:`SLICE` elements is updated a slice of its
flat view at a time, which gives the same bits (the update is
elementwise) and keeps the f32 temporaries near a gigabyte whatever the
largest leaf: qwen2-72b's embedding and ``lm_head`` hold 1,245,708,288
elements each, and a whole-leaf update of one of them would hold about
20 GB of temporaries beside the state.  Such a leaf's sum of squares
(for the gradient norm) is the sum of its slices' sums.

Sharded parameters (``DTensor``, ``distributed.sharding.shard_model``)
give sharded moments and master copy, placed as the parameters are.  The
update is elementwise, so each rank updates its local blocks; only the
gradient norm spans the mesh: each leaf's local sum of squares, divided
by the number of ranks that hold the same block, summed over every mesh
axis, so every rank clips by the norm of the whole gradient.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.distributed.parallel import is_dtensor, local_tensor

#: elements of a leaf the update and the gradient norm take at a time
SLICE = 1 << 26


def _slices(*xs: torch.Tensor):
    """``xs`` (same shape) whole, or where they hold more than
    :data:`SLICE` elements, aligned slices of their flat views: the first
    ones are written in place, so they must be contiguous; the last is
    only read (a gradient, flattened with a copy if it is not)."""
    n = xs[0].numel()
    if n <= SLICE:
        yield xs
        return
    flat = [x.view(-1) for x in xs[:-1]] + [xs[-1].reshape(-1)]
    for i in range(0, n, SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of ``x``, a slice at a time past
    :data:`SLICE` elements."""
    parts = [torch.sum(torch.square(s.to(torch.float32)))
             for (s,) in _slices(x)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params: dict, *, master: Optional[bool] = None) -> dict:
    """master=True (auto when params are below fp32) keeps an fp32 master
    copy in the optimizer state: params can then live in bf16 while the
    update math stays fp32."""
    if master is None:
        master = any(p.dtype != torch.float32 for p in params.values())
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    state = {
        "m": zeros,
        "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if master:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in params.items()}
    return state


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1.0) / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  A ``DTensor``
    leaf counts its local block once over the ranks that hold it, and the
    sum runs over every axis of its mesh."""
    from torch.distributed.tensor import Replicate

    leaves, mesh = [], None
    for x in tree.values():
        sq = _sum_squares(local_tensor(x))
        if is_dtensor(x):
            mesh = x.device_mesh
            for i, pl in enumerate(x.placements):
                if isinstance(pl, Replicate) and mesh.size(i) > 1:
                    sq = sq / mesh.size(i)
        leaves.append(sq)
    total = torch.sum(torch.stack(leaves))
    if mesh is not None:
        import torch.distributed as dist

        for i in range(mesh.ndim):
            if mesh.size(i) > 1:
                dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: AdamWConfig):
    """Returns (params, opt_state, metrics): the same dicts, updated in
    place, and {"grad_norm" (before the clip), "lr"}."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    masters = opt_state.get("master", params)
    for name, param in params.items():
        ndim = param.ndim  # of the whole leaf; the rest are local blocks
        for p, w, m, v, g in _slices(
                local_tensor(param), local_tensor(masters[name]),
                local_tensor(opt_state["m"][name]),
                local_tensor(opt_state["v"][name]), local_tensor(grads[name])):
            g = g.to(torch.float32) * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            mh = m / bc1
            vh = v / bc2
            step_delta = mh / (torch.sqrt(vh) + cfg.eps)
            if ndim >= 2:  # decay matrices only (norms/bias exempt)
                step_delta = step_delta + cfg.weight_decay * w.to(
                    torch.float32)
            new_w = w.to(torch.float32) - lr * step_delta
            if masters is not params:
                w.copy_(new_w)
            p.copy_(new_w.to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
