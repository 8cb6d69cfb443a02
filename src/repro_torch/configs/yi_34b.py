"""Yi-34B [dense] — llama-arch GQA kv=8.

[arXiv:2403.04652; hf].  60L d_model=7168 56H d_ff=20480 vocab=64000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    norm="rmsnorm",
    rope_theta=5000000.0,
    citation="[arXiv:2403.04652; hf]",
)
