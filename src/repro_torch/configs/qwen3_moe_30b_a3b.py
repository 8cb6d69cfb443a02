"""Qwen3-30B-A3B [moe] — 128 experts top-8, GQA kv=4, QK-norm.

[hf:Qwen/Qwen3-30B-A3B; hf].  48L d_model=2048 32H d_ff(expert)=768
vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(
        n_routed=128,
        top_k=8,
        d_expert_ff=768,
        n_shared=0,
        capacity_factor=1.25,
    ),
    citation="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
