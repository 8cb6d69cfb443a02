"""Zamba2-1.2B [hybrid] — Mamba-2 backbone + shared attention blocks.

[arXiv:2411.15242; hf].  38L d_model=2048, shared attn block (32H kv=32,
runs at 2*d on concat(h, emb)) applied every 6 layers; d_ff=8192,
vocab=32000, ssm_state=64, mamba2 headdim=64.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,  # at the shared block's 2*d width
    d_ff=8192,
    vocab=32000,
    norm="rmsnorm",
    rope_theta=10000.0,
    ssm=SSMConfig(
        kind="mamba2",
        d_state=64,
        d_conv=4,
        expand=2,
        headdim=64,
        chunk=256,
    ),
    hybrid=HybridConfig(shared_attn_every=6, concat_embedding=True),
    citation="[arXiv:2411.15242; hf]",
)
