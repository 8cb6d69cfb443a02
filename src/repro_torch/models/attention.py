"""Attention: GQA/MHA and MLA, full-sequence and decode-with-cache.

Counterpart of the reference's ``models/attention.py``.  The reference
computes every full-sequence attention with its chunked online-softmax
jnp path, validated against the same oracle as its Pallas
``flash_attention`` kernel.  The port sends that case through the kernel's
counterpart, ``repro_torch.kernels.flash_attention`` (the CUDA kernel on a
CUDA tensor, its plain version on the CPU) through its autograd Function,
so a training step's gradient runs the backward kernel; decode (one query
against the cache) stays plain torch, as the reference's naive path.
An encoder-decoder's cross-attention (a decoder's S queries over the
encoder's Se keys, not causal) runs the same kernel with keys of their
own length; its one-query decode step stays on the naive path.

MLA (DeepSeek-V2) materialises per-head K and V from the rank-r latent for
a full sequence or a prefill, and runs the same kernel with q.k over
``qk_nope + qk_rope`` dims and v over ``v_head_dim``; its decode is the
reference's absorbed attention against the cached latent, in plain torch.
The int8 KV cache (``kv_cache_quant``) stores per-row int8 codes and bf16
scales, for GQA's k and v and for MLA's latent, and attends over the
dequantised rows, as the reference does.

On a mesh (``distributed/``) a GQA attention whose effective KV heads
divide the model axis runs over this rank's heads: q, k and v from this
rank's columns, its heads' attention through the kernel, the output
projection from its rows, the partial outputs summed over the model axis
(``parallel.attention_group``).  ``kv_cache_shard="seq"`` is, as in the
reference, a placement of the cache: its sequence axis split over the
model axis.  Then every rank computes every head, writes the cache rows
it owns, and a decode step combines the ranks' softmax statistics over
their positions (flash-decode: the maximum, then the rescaled sums and
outputs, each one all-reduce).  A cache whose head width is split (the
reference's fallback when KV heads do not divide the model axis) sums
the scores' partial products over the model axis and gathers the
outputs.  The local cache views carry their placement under
:data:`KV_SHARD`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import parallel
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import (Dense, Norm, apply_rope, dense_apply,
                                       norm_apply, torch_dtype)

NEG_INF = -1e30
#: the key of a local cache view's placement (:class:`KVShard`)
KV_SHARD = "shard"
CACHE_SHARDS = ("heads", "seq")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a cache placement the reference does not have."""
    if cfg.kv_cache_shard not in CACHE_SHARDS:
        raise ValueError(f"kv_cache_shard={cfg.kv_cache_shard!r}: the "
                         f"placements are {CACHE_SHARDS}")


class KVShard(NamedTuple):
    """How one rank's view of an attention cache is split over the model
    axis ``group`` (a ``parallel.Group``): ``"heads"`` (this rank's KV
    heads), ``"seq"`` (positions ``[rank * n, (rank + 1) * n)`` of the
    cache's ``n * size``) or ``"hd"`` (a slice of every head's width; the
    int8 scales whole)."""

    dim: str
    group: object


# ==========================================================================
# Parameters
# ==========================================================================
class Attention(nn.Module):
    """Standard q/k/v/o projections for MHA/GQA (``init_attention``)."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=cfg.param_dtype, device=device, generator=generator)
        self.wq = Dense(d, h * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Dense(d, kvh * hd, bias=cfg.qkv_bias, **kw)
        self.wv = Dense(d, kvh * hd, bias=cfg.qkv_bias, **kw)
        self.wo = Dense(h * hd, d, **kw)
        norm = dict(dtype=cfg.param_dtype, device=device)
        self.q_norm = Norm("rmsnorm", hd, **norm) if cfg.qk_norm else None
        self.k_norm = Norm("rmsnorm", hd, **norm) if cfg.qk_norm else None


class MLAAttention(nn.Module):
    """DeepSeek-V2 MLA projections (``init_mla_attention``): ``wq`` (or,
    with ``q_lora_rank``, ``wq_a``, ``q_a_norm`` and ``wq_b``), the joint
    down-projection ``wkv_a`` to the latent and the shared rope key,
    ``kv_a_norm``, the up-projection ``wkv_b`` to per-head k_nope and v,
    and ``wo``."""

    def __init__(self, cfg: ArchConfig, *, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(dtype=cfg.param_dtype, device=device, generator=generator)
        norm = dict(dtype=cfg.param_dtype, device=device)
        self.wq = self.wq_a = self.q_a_norm = self.wq_b = None
        if m.q_lora_rank:
            self.wq_a = Dense(d, m.q_lora_rank, **kw)
            self.q_a_norm = Norm("rmsnorm", m.q_lora_rank, **norm)
            self.wq_b = Dense(m.q_lora_rank, h * qk_dim, **kw)
        else:
            self.wq = Dense(d, h * qk_dim, **kw)
        self.wkv_a = Dense(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw)
        self.kv_a_norm = Norm("rmsnorm", m.kv_lora_rank, **norm)
        self.wkv_b = Dense(m.kv_lora_rank,
                           h * (m.qk_nope_head_dim + m.v_head_dim), **kw)
        self.wo = Dense(h * m.v_head_dim, d, **kw)


# ==========================================================================
# Core softmax-attention over explicit q/k/v (heads grouped for GQA)
# ==========================================================================
def _naive_attention(q, k, v, *, causal: bool, q_pos, kv_pos, kv_len=None):
    """q: [B,Sq,KV,G,D]; k,v: [B,Skv,KV,D]. Returns [B,Sq,KV,G,D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgd,bpkd->bkgqp", q.float(), k.float())
    s = s * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    if kv_len is not None:
        mask = mask & (kv_pos[None, :] < kv_len)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bqkgd", w, v.float())
    return out.to(q.dtype)


def _flash_attention(q, k, v, *, causal: bool):
    """The kernel over q [B,S,KV,G,Dqk], k [B,Skv,KV,Dqk] and v
    [B,Skv,KV,Dv] (Skv == S when causal): query head ``kv*G + g`` reads
    KV head ``kv``, as the kernel's ``bh // G`` does; the output takes v's
    width.  Differentiable: the gradients come back in these layouts."""
    B, S, KV, G, D = q.shape
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, S, D)
    out = flash_attention_op(qh, k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal)
    return out.reshape(B, KV, G, S, v.shape[-1]).permute(0, 3, 1, 2, 4)


def grouped_attention(q, k, v, *, causal, q_pos, kv_pos, impl="chunked",
                      q_chunk=512, kv_chunk=512, kv_len=None):
    """Dispatch over attention implementations. Shapes as in
    ``_naive_attention``.

    ``chunked`` and ``chunked_noskip`` (the reference's online-softmax
    paths, with and without the causal block skip: one function) run the
    flash kernel when queries and keys are the same sequence, and, not
    causal and without ``kv_len``, over keys of another length (the
    encoder-decoder's cross-attention: ``q_pos = arange(S)`` over
    ``kv_pos = arange(Se)``, where no position masks another).  Under
    ``causal`` the kernel masks by index, which is the positional mask
    when ``q_pos`` is ``kv_pos``, as every caller passes them.
    ``q_chunk`` and ``kv_chunk`` are the reference's tiling and do not
    change the function."""
    Sq, Skv = q.shape[1], k.shape[1]
    if impl == "naive" or Sq == 1:
        return _naive_attention(q, k, v, causal=causal, q_pos=q_pos,
                                kv_pos=kv_pos, kv_len=kv_len)
    if impl in ("chunked", "chunked_noskip"):
        cross = not causal and kv_len is None
        if not cross and (Sq != Skv or kv_len is not None
                          or q_pos is not kv_pos):
            raise NotImplementedError(
                "the port's full-sequence attention takes queries and keys "
                "of one sequence, or, not causal, keys of another length "
                "(no caller of the reference passes others)")
        return _flash_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")


def _kv_quant(x: torch.Tensor):
    """Per-(batch, position, head) int8 quantization of K/V rows: codes
    from the f32 scale (round half to even, as ``jnp.round``), the scale
    stored in bf16."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True)
    scale = scale.clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0].to(torch.bfloat16)


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(torch_dtype(dtype))


def _cache_write(cache: dict, rows: dict, idx: int) -> None:
    """``cache[name][:, idx:idx + S] = rows[name]`` in the cache's dtype,
    in place.  A cache placed by sequence takes only the rows it owns, at
    their local offsets; one placed by head width its slice of the k and
    v rows."""
    shard = cache.get(KV_SHARD)
    for name, x in rows.items():
        c = cache[name]
        at = idx
        if shard is not None and shard.dim == "seq":
            n = c.shape[1]
            lo, hi = max(idx, shard.group.rank * n), min(
                idx + x.shape[1], (shard.group.rank + 1) * n)
            if lo >= hi:
                continue
            x, at = x[:, lo - idx:hi - idx], lo - shard.group.rank * n
        elif shard is not None:  # rows of every head, or the whole width
            for d in range(2, x.dim()):
                if x.shape[d] != c.shape[d]:
                    x = parallel.local_slice(x, d, shard.group)
        c[:, at:at + x.shape[1]] = x.to(c.dtype)


def _decode_seq(q, ck, cv, shard: KVShard, cache_len):
    """One query per row over a cache placed by sequence: this rank's
    softmax statistics over its positions, combined over the model axis
    (the maximum, then the rescaled sums and outputs).  q: [B,1,KV,G,D];
    ck, cv: this rank's [B,n,KV,D] rows.  Returns [B,1,KV,G,D]."""
    import torch.distributed as dist

    g = shard.group
    n = ck.shape[1]
    kv_pos = torch.arange(n, device=q.device) + g.rank * n
    s = torch.einsum("bqkgd,bpkd->bkgqp", q.float(), ck.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.where(kv_pos < cache_len, s, torch.full_like(s, NEG_INF))
    m_loc = s.amax(dim=-1)
    m = m_loc.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g.group)
    p = torch.exp(s - m[..., None])
    acc = torch.cat([torch.einsum("bkgqp,bpkd->bkgqd", p, cv.float()),
                     p.sum(-1)[..., None]], dim=-1)
    dist.all_reduce(acc, group=g.group)
    out = acc[..., :-1] / acc[..., -1:]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _decode_hd(q, ck, cv, shard: KVShard, cache_len):
    """One query per row over a cache whose head width is split: the
    scores' partial products summed over the model axis, the softmax, and
    each rank's slice of the output gathered.  q: [B,1,KV,G,D] whole;
    ck, cv: [B,Skv,KV,D/M].  Returns [B,1,KV,G,D]."""
    import torch.distributed as dist

    g = shard.group
    qs = parallel.local_slice(q, 4, g)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qs.float(), ck.float())
    dist.all_reduce(s, group=g.group)
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    kv_pos = torch.arange(ck.shape[1], device=q.device)
    s = torch.where(kv_pos < cache_len, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bqkgd", w, cv.float()).contiguous()
    parts = [torch.empty_like(out) for _ in range(g.size)]
    dist.all_gather(parts, out, group=g.group)
    return torch.cat(parts, dim=-1).to(q.dtype)


# ==========================================================================
# GQA block (full-sequence, prefill into a cache, single-token decode)
# ==========================================================================
def attention_apply(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                    causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    kv_cache: Optional[dict] = None,
                    cache_index: Optional[int] = None,
                    cache_len: Optional[int] = None):
    """x: [B, S, d].  Returns (out [B,S,d], cache|None).

    With ``kv_cache`` ({"k", "v"}: [B, max_len, KV, D], or under
    ``kv_cache_quant`` int8 {"k", "v"} with bf16 {"k_scale", "v_scale"}:
    [B, max_len, KV]) the new k and v are written at ``cache_index`` IN
    PLACE (the reference returns an updated copy; the port returns the
    same, updated dict).  S == 1 is a decode step over
    ``cache[:cache_len]``; S > 1 is a prefill and needs ``cache_index ==
    0``.  An int8 cache is attended dequantised, in the prefill too."""
    check_supported(cfg)
    B, S, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    g = parallel.attention_group(cfg)  # this rank's heads only
    if g is not None:
        x = parallel.copy_to(x, g)

    q = dense_apply(p.wq, x, cd)
    k = dense_apply(p.wk, x, cd)
    v = dense_apply(p.wv, x, cd)
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, k.shape[2], hd)
    if cfg.qk_norm:
        q = norm_apply("rmsnorm", p.q_norm, q)
        k = norm_apply("rmsnorm", p.k_norm, k)

    if positions is None:
        positions = torch.arange(S, device=x.device)
        if cache_index is not None:
            positions = positions + int(cache_index)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    rep = cfg.kv_repeat
    if rep > 1:  # vLLM-style KV-head replication so TP divides the KV axis
        assert (h // kvh) % rep == 0, (h // kvh, rep)
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    k_all, v_all = k, v  # every effective KV head, where this rank has them
    if g is not None and k.shape[2] == kvh * rep:
        k, v = parallel.local_slice(k, 2, g), parallel.local_slice(v, 2, g)
    # query head e * G' + j reads effective KV head e
    q = q.reshape(B, S, k.shape[2], q.shape[2] // k.shape[2], hd)

    if kv_cache is None:
        out = grouped_attention(q, k, v, causal=causal, q_pos=positions,
                                kv_pos=positions, impl=cfg.attention_impl,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        idx = int(cache_index)
        shard = kv_cache.get(KV_SHARD)
        if "k_scale" in kv_cache:  # int8 rows + bf16 per-row scales
            kq, ks = _kv_quant(k_all)
            vq, vs = _kv_quant(v_all)
            _cache_write(kv_cache, {"k": kq, "v": vq, "k_scale": ks,
                                    "v_scale": vs}, idx)

            def rows(n: int):
                out = []
                for c in ("k", "v"):
                    codes = kv_cache[c][:, :n]
                    scale = kv_cache[f"{c}_scale"][:, :n]
                    if scale.shape[2] != codes.shape[2]:  # scales whole
                        scale = parallel.local_slice(scale, 2, shard.group)
                    out.append(_kv_dequant(codes, scale, k.dtype))
                return tuple(out)

            def prompt_rows():
                return (_kv_dequant(kq, ks, k.dtype),
                        _kv_dequant(vq, vs, k.dtype))
        else:
            _cache_write(kv_cache, {"k": k, "v": v}, idx)

            def rows(n: int):
                return kv_cache["k"][:, :n], kv_cache["v"][:, :n]

            def prompt_rows():
                return k, v
        if S == 1:  # decode: the naive path over the cache, as the reference
            ck, cv = rows(kv_cache["k"].shape[1])
            if shard is not None and shard.dim == "seq":
                out = _decode_seq(q, ck, cv, shard, cache_len)
            elif shard is not None and shard.dim == "hd":
                out = _decode_hd(q, ck, cv, shard, cache_len)
            else:
                kv_pos = torch.arange(ck.shape[1], device=x.device)
                out = grouped_attention(q, ck, cv, causal=False,
                                        q_pos=positions, kv_pos=kv_pos,
                                        impl=cfg.attention_impl,
                                        kv_len=cache_len)
        elif idx == 0:
            # Prefill from an empty cache.  The reference attends over the
            # whole max_len cache with a causal mask and kv_len = S; every
            # key at a position >= S is masked there by both, so that is
            # causal attention over the cache's first S rows (the prompt's
            # k and v as just written, dequantised from an int8 cache),
            # which is what the kernel takes.  A cache placed by sequence
            # or head width holds only a part of them; every rank computed
            # them all, and attends over them as they were written.
            whole = shard is not None and shard.dim in ("seq", "hd")
            ck, cv = prompt_rows() if whole else rows(S)
            out = grouped_attention(q, ck, cv, causal=True, q_pos=positions,
                                    kv_pos=positions, impl=cfg.attention_impl,
                                    q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk)
        else:
            raise NotImplementedError(
                "prefill at cache_index > 0 (a chunked prefill) has no "
                "caller in the reference and is not ported")

    out = out.reshape(B, S, -1)
    out = dense_apply(p.wo, out, cd)
    if g is not None:  # the heads' partial outputs
        out = parallel.reduce_from(out, g)
    return out, kv_cache


# ==========================================================================
# MLA block (DeepSeek-V2).
#
# Full sequence and prefill: the latent is up-projected once to per-head K
# and V and attention runs through the flash kernel at q.k width
# qk_nope + qk_rope and v width v_head_dim.  Decode: the absorbed
# formulation, W_uk folded into the query and W_uv into the output, so the
# scores and values are computed against the cached rank-r latent.
# ==========================================================================
def _mla_qkv_latent(p: MLAAttention, x: torch.Tensor, cfg: ArchConfig,
                    positions):
    """Shared first stage: queries + compressed latent (+rope key)."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    cd = cfg.compute_dtype
    if m.q_lora_rank:
        cq = dense_apply(p.wq_a, x, cd)
        cq = norm_apply("rmsnorm", p.q_a_norm, cq)
        q = dense_apply(p.wq_b, cq, cd)
    else:
        q = dense_apply(p.wq, x, cd)
    q = q.reshape(B, S, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = dense_apply(p.wkv_a, x, cd)  # [B,S,r+dr]
    c_kv = norm_apply("rmsnorm", p.kv_a_norm, kv_a[..., :m.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]  # [B,S,dr], shared by heads
    return q_nope, q_rope, c_kv, k_rope


def _mla_materialised(p: MLAAttention, q_nope, q_rope, c_kv, k_rope,
                      cfg: ArchConfig, *, causal: bool, positions):
    """Attention of the S queries over the S keys of ``c_kv`` [B,S,r] and
    ``k_rope`` [B,S,dr] (the same positions), with per-head K and V
    materialised from the latent: the kernel at G = 1, q.k over
    ``dn + dr`` dims and v over ``dv``.  Returns [B,S,h,dv]."""
    m = cfg.mla
    B, S = c_kv.shape[:2]
    h = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    kvb = dense_apply(p.wkv_b, c_kv, cfg.compute_dtype).reshape(
        B, S, h, dn + dv)
    k_nope, vv = kvb[..., :dn], kvb[..., dn:]
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)],
                       dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]  # G=1
    out = grouped_attention(q_full, k_full, vv, causal=causal,
                            q_pos=positions, kv_pos=positions,
                            impl=cfg.attention_impl, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    return out[:, :, :, 0]


def _mla_absorbed_attention(p: MLAAttention, q_nope, q_rope, c_kv, k_rope,
                            cfg: ArchConfig, cache_len=None):
    """Decode attention in latent space. q_*: [B,1,h,*]; c_kv: [B,Skv,r]."""
    m = cfg.mla
    B, S, h, dn = q_nope.shape
    Skv = c_kv.shape[1]
    dv = m.v_head_dim
    w_kv_b = p.wkv_b.w.float().reshape(m.kv_lora_rank, h, dn + dv)
    w_uk = w_kv_b[..., :dn]  # [r,h,dn]
    w_uv = w_kv_b[..., dn:]  # [r,h,dv]

    c = c_kv.float()
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk)
    s = torch.einsum("bqhr,bpr->bhqp", q_lat, c)
    s = s + torch.einsum("bqhd,bpd->bhqp", q_rope.float(), k_rope.float())
    s = s / math.sqrt(dn + m.qk_rope_head_dim)
    if cache_len is not None:
        kv_pos = torch.arange(Skv, device=s.device)
        s = torch.where(kv_pos < cache_len, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqp,bpr->bqhr", w, c)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)
    return out.to(torch_dtype(cfg.compute_dtype))


def mla_apply(p: MLAAttention, x: torch.Tensor, cfg: ArchConfig, *,
              causal: bool = True, positions: Optional[torch.Tensor] = None,
              kv_cache: Optional[dict] = None,
              cache_index: Optional[int] = None,
              cache_len: Optional[int] = None):
    """x: [B, S, d].  Returns (out [B,S,d], cache|None).

    With ``kv_cache`` ({"c_kv": [B, max_len, r], "k_rope": [B, max_len,
    dr]}, or under ``kv_cache_quant`` an int8 "c_kv" with a bf16
    "c_kv_scale" [B, max_len]) the new latent rows are written at
    ``cache_index`` in place.  S == 1 is a decode step (the absorbed
    attention over ``cache[:cache_len]``); S > 1 is a prefill and needs
    ``cache_index == 0``."""
    check_supported(cfg)
    m = cfg.mla
    B, S, _ = x.shape
    h, dv = cfg.n_heads, m.v_head_dim
    cd = cfg.compute_dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)
        if cache_index is not None:
            positions = positions + int(cache_index)

    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(p, x, cfg, positions)

    if kv_cache is None:
        out = _mla_materialised(p, q_nope, q_rope, c_kv, k_rope, cfg,
                                causal=causal, positions=positions)
    else:
        idx = int(cache_index)
        if "c_kv_scale" in kv_cache:  # int8 latent + bf16 per-row scales
            cq, cs = _kv_quant(c_kv)
            _cache_write(kv_cache, {"c_kv": cq, "c_kv_scale": cs,
                                    "k_rope": k_rope}, idx)

            def latent(n: int):
                return _kv_dequant(kv_cache["c_kv"][:, :n],
                                   kv_cache["c_kv_scale"][:, :n], cd)
        else:
            _cache_write(kv_cache, {"c_kv": c_kv, "k_rope": k_rope}, idx)

            def latent(n: int):
                return kv_cache["c_kv"][:, :n]
        if S == 1:
            out = _mla_absorbed_attention(
                p, q_nope, q_rope, latent(kv_cache["c_kv"].shape[1]),
                kv_cache["k_rope"], cfg, cache_len=cache_len)
        elif idx == 0:
            # Prefill from an empty cache.  The reference materialises K
            # and V from the whole max_len latent cache and attends with a
            # causal mask and kv_len = S; every key at a position >= S is
            # masked there by both, so only the cache's first S rows (the
            # prompt's latent as just written, dequantised from an int8
            # cache) are materialised here.
            out = _mla_materialised(p, q_nope, q_rope, latent(S),
                                    kv_cache["k_rope"][:, :S], cfg,
                                    causal=True, positions=positions)
        else:
            raise NotImplementedError(
                "prefill at cache_index > 0 (a chunked prefill) has no "
                "caller in the reference and is not ported")

    out = out.reshape(B, S, h * dv)
    return dense_apply(p.wo, out, cd), kv_cache
