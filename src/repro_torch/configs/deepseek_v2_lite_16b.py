"""DeepSeek-V2-Lite 16B [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.

[arXiv:2405.04434; hf].  27L d_model=2048 16H d_ff(expert)=1408 vocab=102400.
First layer is dense (d_ff=10944), remaining 26 are MoE.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    norm="rmsnorm",
    rope_theta=10000.0,
    moe=MoEConfig(
        n_routed=64,
        top_k=6,
        d_expert_ff=1408,
        n_shared=2,
        d_shared_ff=1408,
        capacity_factor=1.25,
        first_dense_layers=1,
        d_first_dense_ff=10944,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        q_lora_rank=0,  # V2-Lite uses full-rank q
    ),
    citation="[arXiv:2405.04434; hf]",
)
