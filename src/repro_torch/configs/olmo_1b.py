"""OLMo-1B [dense] — non-parametric LayerNorm, MHA (kv=16), SwiGLU.

[arXiv:2402.00838; hf].  16L d_model=2048 16H d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    norm="layernorm_nonparam",
    rope_theta=10000.0,
    citation="[arXiv:2402.00838; hf]",
)
