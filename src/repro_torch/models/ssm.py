"""State-space model blocks: Mamba-1 (selective scan) and Mamba-2 (SSD).

Counterpart of the reference's ``models/ssm.py``, which is jnp, not a
Pallas kernel, so the port is plain PyTorch.  Both scans are chunked as
the reference's are: a loop over sequence chunks carrying the f32 SSM
state, with the intra-chunk work as an associative scan (Mamba-1) or as
the SSD block decomposition's matmuls (Mamba-2).  A length that is not a
multiple of the chunk runs as one chunk, which is the case of a decode
step (S = 1).

The Mamba-1 scan within a chunk is the odd/even recursion of
``lax.associative_scan``: about two passes over the [B, Q, di, N] decays
and inputs in all, where a doubling scan would make log2(Q).  Its
combine order is the reference's, but XLA may fuse a multiply-add that
torch rounds twice, so results agree to a tolerance, not to the bit.

The deterministic leaves (``A_log``, ``D``, ``dt_bias``, the biases and
norms) are set from the reference's formulas and equal its values
exactly: ``A_log`` is the log that XLA computes for f32 on the CPU
(:func:`_xla_log_f32`, a Cephes polynomial that differs from the
correctly rounded log in the last bit for some arguments) of the
reference's ``arange`` or ``jnp.linspace`` (:func:`_jnp_linspace_f32`,
which also differs from ``torch.linspace``), computed on the host so
every device gets the same bits.

On a mesh whose rules split ``ff`` over ``model`` (``parallel.ssm_group``)
each mixer runs over this rank's share of ``d_inner``, its widths read
from the local weights (``parallel.local_params``): Mamba-1 over its
channels (``in_proj``'s chunk of each of ``xin`` and ``z``), with
``x_proj``'s partial products (``dt_in``, B, C, read by every channel)
summed over ``model`` forward and backward; Mamba-2 over its heads, B and
C projected whole on every rank, the gated RMSNorm's sum of squares
summed over ``model`` in f32.  The input enters through ``dense_cols`` and
the output projection's partial rows leave through ``dense_rows``; the
scans need no collective, and the decode state is this rank's block.
Without a mesh every line computes as it does on one device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.distributed import parallel
from repro_torch.models.layers import (Dense, Norm, _normal, dense_apply,
                                       dense_cols, dense_rows, norm_apply,
                                       torch_dtype)


# ==========================================================================
# Deterministic leaves
# ==========================================================================
_LOG_P = [7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1]


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to f32 (the f64 product of two f32 values
    is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _xla_log_f32(x: np.ndarray) -> np.ndarray:
    """The f32 natural log of positive normal ``x`` as XLA computes it on
    the CPU: the Cephes polynomial (Eigen's ``plog``) with its
    multiply-adds fused."""
    f32 = np.float32
    x = np.asarray(x, f32)
    if not (np.isfinite(x).all() and (x >= np.finfo(f32).tiny).all()):
        raise ValueError("_xla_log_f32 takes positive normal values")
    bits = x.view(np.int32)
    e = ((bits >> 23) - 126).astype(f32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(f32)  # [0.5, 1)
    small = m < f32(0.707106781186547524)
    e = (e - small.astype(f32)).astype(f32)
    m = ((m - f32(1)) + np.where(small, m, f32(0))).astype(f32)
    m2 = (m * m).astype(f32)
    m3 = (m2 * m).astype(f32)
    p = [f32(c) for c in _LOG_P]
    y = _fma32(_fma32(p[0], m, p[1]), m, p[2])
    y1 = _fma32(_fma32(p[3], m, p[4]), m, p[5])
    y2 = _fma32(_fma32(p[6], m, p[7]), m, p[8])
    y = _fma32(_fma32(y, m3, y1), m3, y2)
    y = _fma32(y, m3, (e * f32(-2.12194440e-4)).astype(f32))
    m = (m - (m2 * f32(0.5)).astype(f32)).astype(f32)
    m = (m + y).astype(f32)
    return (m + (e * f32(0.693359375)).astype(f32)).astype(f32)


def _jnp_linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in f32 as XLA computes it on the
    CPU: ``start * (1 - i r) + i (stop r)`` with ``r = 1 / (num - 1)``
    (the division rewritten as a product and reassociated, the last
    multiply-add fused), then ``stop``; bit for bit for ``num`` up to 352
    (zamba2's is 64)."""
    f32 = np.float32
    if num < 2:
        return np.full(num, start, f32)
    i = np.arange(num - 1, dtype=f32)
    r = f32(1.0 / (num - 1))
    head = (f32(start) * (f32(1) - (i * r).astype(f32))).astype(f32)
    head = _fma32(i, (f32(stop) * r).astype(f32), head)
    return np.concatenate([head, np.array([stop], f32)])


def _set(values: np.ndarray, *, dtype, device) -> nn.Parameter:
    """A parameter holding the f32 ``values`` rounded to ``dtype``, made on
    the host (nothing on ``meta``)."""
    dev = torch.device(device)
    dt = torch_dtype(dtype)
    if dev.type == "meta":
        t = torch.empty(values.shape, dtype=dt, device=dev)
    else:
        t = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(dt)
        t = t.to(dev)
    return nn.Parameter(t, requires_grad=False)


def _const(shape, value: float, *, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=torch_dtype(dtype),
                                   device=device), requires_grad=False)


def _conv_weight(k: int, c: int, *, dtype, device, generator) -> nn.Parameter:
    return nn.Parameter(_normal((k, c), scale=0.1, dtype=dtype,
                                device=device, generator=generator),
                        requires_grad=False)


# ==========================================================================
# Shared helpers
# ==========================================================================
def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: [B,S,C]; w: [K,C]; b: [C].

    Returns (y [B,S,C] in x's dtype, new_conv_state [B,K-1,C])."""
    B, S, C = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, C), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)  # [B, S+K-1, C]
    wf = w.float()
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + xp[:, k:k + S].float() * wf[k]
    y = y + b.float()
    return y.to(x.dtype), xp[:, S:]


def _segsum_decay(log_a: torch.Tensor) -> torch.Tensor:
    """log_a: [..., Q].  Returns L[..., i, j] = exp(sum_{t=j+1..i} log_a_t)
    for i >= j, else 0 (the SSD 1-semiseparable decay matrix).

    The reference masks after the exp (``where(mask, exp(diff), 0)``); the
    port masks before it (``exp(where(mask, diff, -inf))``), which gives
    the same values bit for bit.  Above the diagonal ``diff`` is a sum of
    decays' negated logs, and once it passes about 88 its exp overflows
    f32: the masked inf takes a zero gradient, and 0 x inf makes the
    reference's gradient NaN (``jax.grad`` of its ``zoo.loss_fn`` for
    reduced zamba2 is NaN in every Mamba-2 layer, ROADMAP queue 3); here
    the masked entries are exp(-inf) = 0 with a zero gradient."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=log_a.device))
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def _linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (a, b) under the combine
    ``(a_l, b_l), (a_r, b_r) -> (a_l a_r, b_l a_r + b_r)``: returns
    (prod a, h) with ``h_t = a_t h_{t-1} + b_t`` from h = 0.  The odd/even
    recursion of ``lax.associative_scan``: combine adjacent pairs, scan
    them (the odd positions), then combine each with the next even
    element."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_l, a_r = a[:, 0:n - 1:2], a[:, 1::2]
    odd_a, odd_b = _linear_scan(a_l * a_r, b[:, 0:n - 1:2] * a_r + b[:, 1::2])
    m = (n - 1) // 2  # even positions after the first
    a_e, b_e = a[:, 2::2], b[:, 2::2]
    even_a = odd_a[:, :m] * a_e
    even_b = odd_b[:, :m] * a_e + b_e
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2], out_b[:, 2::2] = even_a, even_b
    out_a[:, 1::2], out_b[:, 1::2] = odd_a, odd_b
    return out_a, out_b


def _chunk_len(chunk: int, S: int) -> int:
    """The reference's chunk: ``min(chunk, S)``, or all of S when S is not
    a multiple of it."""
    Q = min(chunk, S)
    return S if S % Q else Q


# ==========================================================================
# Mamba-1 (falcon-mamba-7b)
# ==========================================================================
def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.ssm.dt_rank or int(math.ceil(cfg.d_model / 16))


class Mamba1(nn.Module):
    """``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj`` (with a
    bias), ``A_log`` (S4D-real: log(1..N) per channel), ``D`` and
    ``out_proj`` (``init_mamba1``)."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s: SSMConfig = cfg.ssm
        d, dt = cfg.d_model, cfg.param_dtype
        di, N, r = s.expand * d, s.d_state, _dt_rank(cfg)
        kw = dict(dtype=dt, device=device, generator=generator)
        self.in_proj = Dense(d, 2 * di, **kw)
        self.conv_w = _conv_weight(s.d_conv, di, **kw)
        self.conv_b = _const((di,), 0.0, dtype=dt, device=device)
        self.x_proj = Dense(di, r + 2 * N, **kw)
        self.dt_proj = Dense(r, di, bias=True, **kw)
        # the reference rounds arange(1..N) to the param dtype, then logs
        ar = torch.arange(1, N + 1, dtype=torch.float32).to(torch_dtype(dt))
        self.A_log = _set(np.broadcast_to(_xla_log_f32(ar.float().numpy()),
                                          (di, N)), dtype=dt, device=device)
        self.D = _const((di,), 1.0, dtype=dt, device=device)
        self.out_proj = Dense(di, d, **kw)


def _mamba1_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                 chunk: int, h0: Optional[torch.Tensor] = None):
    """Chunked selective scan.

    dA: [B,S,di,N] per-step decay (exp(dt*A)); dBx: [B,S,di,N] per-step
    input (dt*B*x); C: [B,S,N] readout.  Returns (y [B,S,di] f32,
    h_last [B,di,N] f32)."""
    B, S, di, N = dA.shape
    Q = _chunk_len(chunk, S)
    h = (torch.zeros((B, di, N), dtype=torch.float32, device=dA.device)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, S, Q):
        A_cum, B_cum = _linear_scan(dA[:, c0:c0 + Q].float(),
                                    dBx[:, c0:c0 + Q].float())
        h_t = A_cum * h[:, None] + B_cum  # [B,Q,di,N]
        del A_cum, B_cum
        ys.append(torch.einsum("bqdn,bqn->bqd", h_t,
                               C[:, c0:c0 + Q].float()))
        h = h_t[:, -1].clone()
        del h_t
    return torch.cat(ys, dim=1), h


def mamba1_apply(p: Mamba1, x: torch.Tensor, cfg: ArchConfig, *,
                 state: Optional[dict] = None):
    """x: [B,S,d].  state (decode): {'conv': [B,K-1,di], 'ssm': [B,di,N]}.

    Returns (y [B,S,d], new_state or None); ``state`` is not written."""
    s: SSMConfig = cfg.ssm
    cd = cfg.compute_dtype
    r = _dt_rank(cfg)
    g = parallel.ssm_group(cfg)  # this rank's channels only
    xz, = dense_cols((p.in_proj,), x, cd, g)
    di = xz.shape[-1] // 2  # this rank's channels: [xin | z]
    xin, z = xz[..., :di], xz[..., di:]
    xc, new_conv = _causal_conv(xin, p.conv_w, p.conv_b,
                                state["conv"] if state is not None else None)
    xc = F.silu(xc)

    # every channel reads dt_in, B and C: summed over the channels' group
    proj = parallel.copy_to_f32(dense_rows(p.x_proj, xc, cd, g), g)
    dt_in = proj[..., :r]
    Bm = proj[..., r:r + s.d_state].float()
    Cm = proj[..., r + s.d_state:].float()
    dt = F.softplus(dense_apply(p.dt_proj, dt_in, torch.float32))  # [B,S,di]

    A = -torch.exp(p.A_log.float())  # [di,N]
    dA = (dt[..., None] * A).exp_()  # [B,S,di,N]
    dBx = (dt * xc.float())[..., None] * Bm[:, :, None, :]
    del dt

    h0 = state["ssm"].float() if state is not None else None
    y, h_last = _mamba1_scan(dA, dBx, Cm, s.chunk, h0)
    del dA, dBx
    y = y + xc.float() * p.D.float()
    y = y.to(torch_dtype(cd)) * F.silu(z)
    out = dense_rows(p.out_proj, y, cd, g)  # the channels' partial outputs
    new_state = ({"conv": new_conv, "ssm": h_last}
                 if state is not None else None)
    return out, new_state


def mamba1_state_specs(cfg: ArchConfig, batch: int) -> dict:
    """The decode state's shapes and dtypes as ``meta`` tensors."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    cd = torch_dtype(cfg.compute_dtype)
    return {"conv": torch.empty((batch, s.d_conv - 1, di), dtype=cd,
                                device="meta"),
            "ssm": torch.empty((batch, di, s.d_state), dtype=torch.float32,
                               device="meta")}


# ==========================================================================
# Mamba-2 / SSD (zamba2): separate z | x | B | C | dt projections
# ==========================================================================
class Mamba2(nn.Module):
    """``in_z``, ``in_x``, ``in_B``, ``in_C``, ``in_dt``, three conv pairs,
    ``A_log`` (log(linspace(1, 16, H))), ``D``, ``dt_bias``, the gated
    ``norm`` and ``out_proj`` (``init_mamba2``)."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s: SSMConfig = cfg.ssm
        d, dt = cfg.d_model, cfg.param_dtype
        di, N = s.expand * d, s.d_state
        H = di // s.headdim
        kw = dict(dtype=dt, device=device, generator=generator)
        self.in_z = Dense(d, di, **kw)
        self.in_x = Dense(d, di, **kw)
        self.in_B = Dense(d, N, **kw)
        self.in_C = Dense(d, N, **kw)
        self.in_dt = Dense(d, H, **kw)
        for name, c in (("x", di), ("B", N), ("C", N)):
            setattr(self, f"conv_{name}_w", _conv_weight(s.d_conv, c, **kw))
            setattr(self, f"conv_{name}_b",
                    _const((c,), 0.0, dtype=dt, device=device))
        self.A_log = _set(_xla_log_f32(_jnp_linspace_f32(1.0, 16.0, H)),
                          dtype=dt, device=device)
        self.D = _const((H,), 1.0, dtype=dt, device=device)
        self.dt_bias = _const((H,), 0.0, dtype=dt, device=device)
        self.norm = Norm("rmsnorm", di, dtype=dt, device=device)
        self.out_proj = Dense(di, d, **kw)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD (Mamba-2) forward.

    xh: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    Bm, Cm: [B,S,N].  Returns (y [B,S,H,P] f32, h_last [B,H,P,N] f32)."""
    B, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = _chunk_len(chunk, S)
    h = (torch.zeros((B, H, Pd, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    ys = []
    for c0 in range(0, S, Q):
        cut = slice(c0, c0 + Q)
        x_q, dt_q = xh[:, cut].float(), dt[:, cut].float()
        B_q, C_q = Bm[:, cut].float(), Cm[:, cut].float()
        la_h = (dt_q * A).transpose(1, 2)  # [B,H,Q] log-decay per step
        L = _segsum_decay(la_h)  # [B,H,Q,Q]
        scores = torch.einsum("bqn,bpn->bqp", C_q, B_q)  # [B,Q,Q]
        M = scores[:, None] * L
        dx = x_q * dt_q[..., None]  # [B,Q,H,P]
        y_intra = torch.einsum("bhqp,bphd->bqhd", M, dx)
        # inter-chunk: the carried state's contribution
        decay_from_start = torch.exp(torch.cumsum(la_h, dim=-1))  # [B,H,Q]
        y_inter = torch.einsum("bqn,bhpn,bhq->bqhp", C_q, h,
                               decay_from_start)
        # h' = total decay * h + sum_t decay_to_end[t] dx_t B_t^T
        total = decay_from_start[..., -1]  # [B,H]
        decay_to_end = torch.exp(
            torch.flip(torch.cumsum(torch.flip(la_h, [-1]), dim=-1), [-1])
            - la_h)
        contrib = torch.einsum("bqhp,bqn,bhq->bhpn", dx, B_q, decay_to_end)
        h = h * total[..., None, None] + contrib
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _rmsnorm_split(p: Norm, x: torch.Tensor, width: int,
                   g: "parallel.Group", eps: float = 1e-5) -> torch.Tensor:
    """``norm_apply``'s RMSNorm of a row of ``width`` whose channels are
    split over ``g``: ``x`` is this rank's [..., width / M] and ``p`` its
    chunk of the scale; the sum of squares is summed over the group in
    f32, and its gradient too (every rank's chunk divides by it)."""
    xf = x.float()
    ss = parallel.all_reduce_sum(torch.sum(xf * xf, dim=-1, keepdim=True),
                                 g)
    y = xf * torch.rsqrt(ss / width + eps) * p.scale.float()
    return y.to(x.dtype)


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg: ArchConfig, *,
                 state: Optional[dict] = None):
    """x: [B,S,d].  state (decode): {'conv_x', 'conv_B', 'conv_C', 'ssm'}.

    Returns (y [B,S,d], new_state or None); ``state`` is not written."""
    s: SSMConfig = cfg.ssm
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    g = parallel.ssm_group(cfg)  # this rank's heads only
    z, xin, Braw, Craw, dt_raw = dense_cols(
        (p.in_z, p.in_x, p.in_B, p.in_C, p.in_dt), x, cd, g)
    di = xin.shape[-1]  # this rank's heads' channels
    H = di // s.headdim

    cs = state if state is not None else {}
    xc, new_conv_x = _causal_conv(xin, p.conv_x_w, p.conv_x_b,
                                  cs.get("conv_x"))
    Bc, new_conv_B = _causal_conv(Braw, p.conv_B_w, p.conv_B_b,
                                  cs.get("conv_B"))
    Cc, new_conv_C = _causal_conv(Craw, p.conv_C_w, p.conv_C_b,
                                  cs.get("conv_C"))
    xc = F.silu(xc)
    # every head reads B and C (computed alike on every rank under a mesh)
    Bm = parallel.copy_to_f32(F.silu(Bc), g, share=True).float()
    Cm = parallel.copy_to_f32(F.silu(Cc), g, share=True).float()
    xh = xc.reshape(B, S, H, s.headdim)

    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())  # [H]

    h0 = state["ssm"].float() if state is not None else None
    y, h_last = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, h0)
    y = y + xh.float() * p.D.float()[None, None, :, None]
    y = y.reshape(B, S, di).to(torch_dtype(cd))
    if g is None:
        y = norm_apply("rmsnorm", p.norm, y * F.silu(z))
    else:
        y = _rmsnorm_split(p.norm, y * F.silu(z), s.expand * cfg.d_model, g)
    out = dense_rows(p.out_proj, y, cd, g)  # the heads' partial outputs
    new_state = None
    if state is not None:
        new_state = {"conv_x": new_conv_x, "conv_B": new_conv_B,
                     "conv_C": new_conv_C, "ssm": h_last}
    return out, new_state


def mamba2_state_specs(cfg: ArchConfig, batch: int) -> dict:
    """The decode state's shapes and dtypes as ``meta`` tensors."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.headdim
    cd = torch_dtype(cfg.compute_dtype)

    def meta(shape, dtype=cd):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {"conv_x": meta((batch, s.d_conv - 1, di)),
            "conv_B": meta((batch, s.d_conv - 1, s.d_state)),
            "conv_C": meta((batch, s.d_conv - 1, s.d_state)),
            "ssm": meta((batch, H, s.headdim, s.d_state), torch.float32)}
