"""The yardstick's arithmetic: published peaks of the card, the model's
useful work, and the attention kernel's least time.

``PEAK_FLOPS_BF16`` and ``HBM_BW`` are copied from
``src/repro_torch/launch/mesh.py`` at commit d863ae1 (NVIDIA's data sheet for
the H100 SXM, dense rates, at the card's full 700 W limit).  ``model_flops``
follows ``src/repro_torch/launch/roofline.py::model_flops_estimate`` of the
same commit (2 x N x tokens for a forward), counted here from the
configuration file and not from the program, with attention added: the
model's work whatever implements it.  ``attention_call`` counts one call of
an attention kernel at the shapes it is given, however the kernel is built.
"""
from __future__ import annotations

from modelspec import ModelSpec, layer_kinds

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12              # bytes/s of HBM3


def _attn_params(s: ModelSpec) -> int:
    d, h = s.d_model, s.n_heads
    if s.mla:
        return (d * h * s.qk_dim
                + d * (s.kv_lora_rank + s.qk_rope_head_dim)
                + s.kv_lora_rank * h * (s.qk_nope_head_dim + s.v_head_dim)
                + h * s.v_head_dim * d)
    return 2 * d * h * s.head_dim + 2 * d * s.n_kv_heads * s.head_dim


def _ffn_params(s: ModelSpec, kind: str) -> int:
    """Matrix parameters a token passes through in one layer's FFN: the
    router, its top-k routed experts and the shared experts of a routed
    layer."""
    d = s.d_model
    if kind == "mlp":
        return 3 * d * s.d_ff
    return (d * s.n_routed + s.top_k * 3 * d * s.d_expert_ff
            + 3 * d * s.n_shared * s.d_expert_ff)


def active_layer_params(s: ModelSpec) -> int:
    """Matrix parameters of the layers that each token's forward passes
    through (no embedding, no head, no norms)."""
    return sum(_attn_params(s) + _ffn_params(s, kind)
               for _, kind in layer_kinds(s))


def projector_params(s: ModelSpec) -> int:
    if not s.frontend_dim:
        return 0
    return s.frontend_dim * s.d_model + s.d_model * s.d_model


def causal_pairs(n: int) -> int:
    """(query, key) pairs of causal attention over ``n`` positions."""
    return n * (n + 1) // 2


def model_flops(s: ModelSpec, lengths, image_tokens: int = 0) -> float:
    """Useful FLOPs of a forward over sequences of the given real lengths
    (each counting its ``image_tokens`` leading patch tokens), returning one
    position's logits per sequence: 2 x active layer parameters x tokens,
    the projector on the image tokens, causal attention at the real
    lengths, and the LM head once per sequence.  Padding and expert
    capacity slack are not work."""
    n_layer = active_layer_params(s)
    attn_per_pair = 2 * s.n_heads * (s.qk_dim + s.v_dim)
    total = 0.0
    for n in lengths:
        total += 2.0 * n_layer * n
        total += 2.0 * projector_params(s) * image_tokens
        total += float(attn_per_pair) * causal_pairs(n) * s.n_layers
        total += 2.0 * s.d_model * s.vocab
    return total


def attention_call(batch: int, q_heads: int, kv_heads: int, seq: int,
                   qk_dim: int, v_dim: int, *, causal: bool = True,
                   elem_bytes: int = 2) -> tuple:
    """(FLOPs, bytes, least seconds) of one attention call over ``seq``
    queries and keys: the products of each needed (query, key) pair, each
    input read once and the output written once; the least time is the
    larger of FLOPs over the bf16 peak and bytes over HBM bandwidth."""
    pairs = causal_pairs(seq) if causal else seq * seq
    flops = 2.0 * batch * q_heads * pairs * (qk_dim + v_dim)
    elems = (batch * q_heads * seq * qk_dim + batch * kv_heads * seq * qk_dim
             + batch * kv_heads * seq * v_dim + batch * q_heads * seq * v_dim)
    nbytes = float(elems * elem_bytes)
    return flops, nbytes, max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BW)
