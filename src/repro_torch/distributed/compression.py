"""Int8 error-feedback gradient compression for the DP all-reduce.

Counterpart of the reference's ``distributed/compression.py``.  At
1000+-node scale the data-parallel gradient all-reduce crosses DCN between
pods; quantizing the payload to int8 with per-tensor scales cuts wire bytes
4x vs fp32 (2x vs bf16).  The quantization residual is fed back into the next
step's gradient (error feedback, 1-bit-Adam-style), which keeps SGD/Adam
convergence.

The port computes what the reference's code computes: each rank
quantizes with its own scale, and the all-reduce sums the dequantized f32
payloads.  (The reference's comment says the int8 payload is summed in
int32; its code sums the dequantized f32, and so does this.)  The
quantization is plain torch: no Pallas kernel computes it.

    g_sync, new_residual = compressed_psum(grad, residual, group=group)
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grad: torch.Tensor, residual: torch.Tensor, *, group):
    """Error-feedback int8 all-reduce of one gradient tensor over the
    process group ``group``.

    Returns (synced mean gradient fp32, new residual)."""
    g = grad.to(torch.float32) + residual
    q, scale = quantize_int8(g)
    sent = dequantize_int8(q, scale)
    new_residual = g - sent
    # per-rank scales: the sum of the dequantized payloads, then the mean
    total = sent.clone()
    dist.all_reduce(total, group=group)
    n = float(dist.get_world_size(group))
    return total / n, new_residual


def tree_compressed_psum(grads: dict, residuals: dict, *, group):
    out_g, out_r = {}, {}
    for name, g in grads.items():
        sg, nr = compressed_psum(g, residuals[name], group=group)
        out_g[name] = sg.to(g.dtype)
        out_r[name] = nr
    return out_g, out_r


def make_dp_compressed_grad_fn(loss_fn, mesh, *, axis_name: str = "data"):
    """Wrap a per-shard loss into a compressed-gradient fn over the mesh
    axis ``axis_name``.

    loss_fn(params, batch_shard) -> scalar.  Params (a dict of tensors)
    replicated over the mesh; batch split on axis 0 over the axis, each
    rank taking its rows.  Returns grad_fn(params, batch, residuals) ->
    (loss_mean, grads, new_residuals).
    """
    dm = mesh.device_mesh
    group = dm.get_group(axis_name)
    rank, n = dm.get_local_rank(axis_name), mesh.shape[axis_name]

    def grad_fn(params: dict, batch: torch.Tensor, residuals: dict):
        rows = batch.shape[0] // n
        shard = batch[rank * rows:(rank + 1) * rows]
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, shard)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads, residuals = tree_compressed_psum(
            dict(zip(leaves, grads)), residuals, group=group)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        return loss / n, grads, residuals

    return grad_fn
