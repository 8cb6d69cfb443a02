"""Core NN primitives: dense layers, norms, rotary embeddings, embeddings,
the SwiGLU MLP, and the GELU of the VLM's patch projector.

Counterpart of the reference's ``models/layers.py``.  Each parameterised
primitive is an ``nn.Module`` built with an explicit ``device`` and
``dtype`` and drawn from a ``torch.Generator``; its attribute names are the
reference's parameter-tree keys (``w``, ``b``, ``scale``, ``table``, ...),
so ``state_dict`` names mirror the reference tree.  The ``*_apply``
functions take the module and keep the reference's casts: weights and
activations in the compute dtype before each product, norms and RoPE in
f32 and cast back to the input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.distributed import parallel

def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config's dtype name (or the dtype itself)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _normal(shape, *, scale: float, dtype, device,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``normal(shape) * scale`` in ``dtype`` on ``device``, drawn in f32
    from ``generator`` on the generator's device (the CPU unless a CUDA
    generator is given, which must be on ``device``); nothing is drawn on
    the ``meta`` device."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch_dtype(dtype), device=dev)
    at = generator.device if generator is not None else torch.device("cpu")
    if at.type != "cpu" and (at.type != dev.type or dev.index not in
                             (None, at.index)):
        raise ValueError(f"a generator on {at} draws on that device, not "
                         f"on {dev}")
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=at)
    return (x.to(torch_dtype(dtype)) * scale).to(dev)


# --------------------------------------------------------------------------
# Dense
# --------------------------------------------------------------------------
class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` laid out ``[d_in, d_out]``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype="float32", device="cpu",
                 generator: Optional[torch.Generator] = None,
                 scale: Optional[float] = None):
        super().__init__()
        scale = float(scale if scale is not None else 1.0 / math.sqrt(d_in))
        self.w = nn.Parameter(_normal((d_in, d_out), scale=scale, dtype=dtype,
                                      device=device, generator=generator),
                              requires_grad=False)
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=torch_dtype(dtype),
                                           device=device),
                               requires_grad=False) if bias else None)


def dense_apply(p: Dense, x: torch.Tensor,
                compute_dtype="bfloat16") -> torch.Tensor:
    cd = torch_dtype(compute_dtype)
    y = torch.matmul(x.to(cd), p.w.to(cd))
    if p.b is not None:
        y = y + p.b.to(cd)
    return y


def dense_rows(p: Dense, x: torch.Tensor, compute_dtype, g) -> torch.Tensor:
    """``dense_apply`` of a projection whose input rows are split over
    the group ``g`` (a ``parallel.Group``; this rank's rows of ``p.w``):
    each rank's partial product in f32, summed over ``g``
    (``parallel.row_product``), rounded to the compute dtype once, as the
    one-device product is, then the bias.  ``dense_apply`` itself where
    ``g`` is None."""
    if g is None:
        return dense_apply(p, x, compute_dtype)
    cd = torch_dtype(compute_dtype)
    y = parallel.row_product(x.to(cd), p.w.to(cd), g).to(cd)
    if p.b is not None:
        y = y + p.b.to(cd)
    return y


def dense_cols(ps, x: torch.Tensor, compute_dtype, g=None) -> list:
    """``dense_apply`` of each projection of ``ps`` on ``x`` (the same
    forward), with ``parallel.column_products``'s gradients: ``x``'s
    summed in f32 over the projections (and over ``g``, where the
    projections' output columns are split over it: this rank's columns)
    and rounded once, each weight's kept in f32.  One device and a mesh
    thus round a region's input gradient alike."""
    cd = torch_dtype(compute_dtype)
    groups = () if g is None else (g,)
    ys = parallel.column_products(x, [p.w for p in ps], cd, *groups)
    return [y if p.b is None else y + p.b.to(cd) for p, y in zip(ps, ys)]


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
class Norm(nn.Module):
    """rmsnorm / layernorm (scale, bias) / layernorm_nonparam (no params)."""

    def __init__(self, kind: str, dim: int, *, dtype="float32",
                 device="cpu"):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm", "layernorm_nonparam"):
            raise ValueError(f"unknown norm kind {kind!r}")
        self.kind = kind
        ones = lambda: nn.Parameter(  # noqa: E731
            torch.ones(dim, dtype=torch_dtype(dtype), device=device),
            requires_grad=False)
        self.scale = ones() if kind != "layernorm_nonparam" else None
        self.bias = (nn.Parameter(torch.zeros(dim, dtype=torch_dtype(dtype),
                                              device=device),
                                  requires_grad=False)
                     if kind == "layernorm" else None)


def norm_apply(kind: str, p: Optional[Norm], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = y * p.scale.float()
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (float32).  The power is
    taken in f64 and rounded to f32, which gives XLA's f32 ``theta ** e``
    on every exponent (f32 ``pow`` on the CPU or the card is off by an
    ulp on some, e.g. one of 64 at head width 128 and theta 1e6 or
    5e6)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate halves (split-half, not interleaved pairs).  x: [..., S, H, D]
    (D even); positions: broadcastable [..., S]."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # [d/2]
    ang = positions[..., None].float() * inv  # [..., S, d/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, d/2]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------
class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, *, dtype="float32",
                 device="cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.table = nn.Parameter(_normal((vocab, d_model), scale=0.02,
                                          dtype=dtype, device=device,
                                          generator=generator),
                                  requires_grad=False)


def embedding_apply(p: Embedding, tokens: torch.Tensor,
                    compute_dtype="bfloat16") -> torch.Tensor:
    # cast-then-gather, as the reference does
    return p.table.to(torch_dtype(compute_dtype))[tokens]


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# --------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype="float32",
                 device="cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.gate = Dense(d_model, d_ff, **kw)
        self.up = Dense(d_model, d_ff, **kw)
        self.down = Dense(d_ff, d_model, **kw)


def mlp_apply(p: MLP, x: torch.Tensor, compute_dtype="bfloat16", *,
              tp=None):
    """The SwiGLU MLP.  With ``tp`` (a ``parallel.Group``: the mesh's
    ``ff`` axis, ``parallel.mlp_group``) ``p`` holds this rank's
    ``gate``/``up`` columns and ``down`` rows (``parallel.local_params``)
    and the partial outputs are summed over the axis."""
    g, u = dense_cols((p.gate, p.up), x, compute_dtype, tp)
    h = torch.nn.functional.silu(g) * u
    return dense_rows(p.down, h, compute_dtype, tp)


# --------------------------------------------------------------------------
# GELU (the VLM projector's)
# --------------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))``, not torch's
    default erf form."""
    return torch.nn.functional.gelu(x, approximate="tanh")
