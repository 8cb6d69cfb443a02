"""Architecture + shape configuration system.

Every assigned architecture gets a ``repro_torch/configs/<id>.py`` defining
``CONFIG = ArchConfig(...)`` with the exact published sizes.  The registry maps
public arch ids (``--arch deepseek-v2-lite-16b``) to those modules.  Reduced
("smoke") variants of the same family are derived mechanically for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional


# --------------------------------------------------------------------------
# Sub-configs
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading dense layers (DeepSeek style)
    d_first_dense_ff: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0  # 0 => full-rank q projection (V2-Lite)


@dataclass(frozen=True)
class SSMConfig:
    kind: str  # 'mamba1' | 'mamba2'
    d_state: int
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64  # mamba2 only
    chunk: int = 256  # scan chunk length
    dt_rank: int = 0  # mamba1; 0 => ceil(d_model/16)


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: SSM backbone + a *shared* attention block every k layers."""

    shared_attn_every: int = 6
    concat_embedding: bool = True  # shared block sees concat(h, initial_emb)


# --------------------------------------------------------------------------
# ArchConfig
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_nonparam
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # encoder-decoder (audio family)
    enc_layers: int = 0  # 0 => decoder-only
    # modality frontend stubs ([vlm]: patch embeddings, [audio]: frame embeddings)
    frontend: str = "none"  # none | patch | frames
    frontend_dim: int = 0  # raw embedding dim produced by the (stub) frontend
    frontend_tokens: int = 0  # tokens contributed by the frontend per sample
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # attention implementation: chunked (flash-style jnp), naive, pallas
    attention_impl: str = "chunked"
    q_chunk: int = 512
    kv_chunk: int = 512
    # serving: replicate each KV head this many times so the effective KV-head
    # count divides the TP axis (vLLM-style num_kv_head_replicas)
    kv_repeat: int = 1
    # serving: KV-cache layout optimizations (SS Perf): int8-quantized cache
    # halves the decode memory term; 'seq' shards the cache on the sequence
    # axis over the TP group (flash-decode-style; kv_repeat stays 1)
    kv_cache_quant: bool = False
    kv_cache_shard: str = "heads"  # heads | seq
    # loss
    loss_chunk: int = 8192  # token-chunked cross-entropy
    # citation tag [source; verified-tier]
    citation: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived ----------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def supports_shape(self, shape: "ShapeSpec") -> bool:
        """long_500k needs sub-quadratic context handling (SSM / hybrid)."""
        if shape.name == "long_500k":
            return self.family in ("ssm", "hybrid")
        return True

    def param_count(self) -> int:
        """Analytic parameter count (matches init; used for 6ND roofline)."""
        from repro_torch.models.zoo import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.zoo import analytic_param_count

        return analytic_param_count(self, active_only=True)


# --------------------------------------------------------------------------
# Shapes (assigned to every architecture)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "deepseek-v2-lite-16b",
    "qwen3-moe-30b-a3b",
    "internvl2-26b",
    "olmo-1b",
    "qwen2-72b",
    "smollm-135m",
    "yi-34b",
    "falcon-mamba-7b",
    "seamless-m4t-medium",
    "zamba2-1.2b",
]


def get_config(arch_id: str) -> ArchConfig:
    """Load ``CONFIG`` from ``repro_torch.configs.<arch_id with - -> _>``."""
    mod_name = "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(mod_name)
    return mod.CONFIG


def get_shape(shape_name: str) -> ShapeSpec:
    return SHAPES[shape_name]


# --------------------------------------------------------------------------
# Reduced (smoke) configs: same family/topology, tiny dims.
# --------------------------------------------------------------------------
def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to CPU-smoke scale, preserving its structural family."""
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    repl: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2 if cfg.hybrid is None else 4),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab=256,
        loss_chunk=64,
        q_chunk=32,
        kv_chunk=32,
    )
    if cfg.moe is not None:
        repl["moe"] = dataclasses.replace(
            cfg.moe,
            n_routed=8,
            top_k=2,
            d_expert_ff=32,
            n_shared=min(cfg.moe.n_shared, 1),
            d_shared_ff=32 if cfg.moe.n_shared else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            d_first_dense_ff=64 if cfg.moe.first_dense_layers else 0,
        )
    if cfg.mla is not None:
        repl["mla"] = dataclasses.replace(
            cfg.mla,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            q_lora_rank=0,
        )
        repl["head_dim"] = 16
    if cfg.ssm is not None:
        repl["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=8, d_conv=4, headdim=16, chunk=16, dt_rank=8
        )
    if cfg.hybrid is not None:
        repl["hybrid"] = dataclasses.replace(cfg.hybrid, shared_attn_every=2)
    if cfg.enc_layers > 0:
        repl["enc_layers"] = 2
    if cfg.frontend != "none":
        repl["frontend_dim"] = 48
        repl["frontend_tokens"] = 8
    return dataclasses.replace(cfg, **repl)


def make_serve_config(cfg: ArchConfig, model_axis: int) -> ArchConfig:
    """Derive the serving variant of a config for a TP axis of given size.

    Picks ``kv_repeat`` so effective KV heads divide the TP axis (when the
    query-group size allows it); params stay bf16 for serving.
    """
    kv_repeat = 1
    if cfg.n_kv_heads and cfg.n_heads:
        g = cfg.n_heads // cfg.n_kv_heads
        # smallest divisor of the query-group size that makes the effective
        # KV head count divide the TP axis (vLLM num_kv_head_replicas)
        for rep in range(1, g + 1):
            if g % rep == 0 and (cfg.n_kv_heads * rep) % model_axis == 0:
                kv_repeat = rep
                break
    return dataclasses.replace(cfg, kv_repeat=kv_repeat, param_dtype="bfloat16")
