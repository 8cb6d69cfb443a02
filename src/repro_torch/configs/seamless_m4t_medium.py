"""SeamlessM4T-medium [audio] — encoder-decoder, multimodal frontend STUB.

[arXiv:2308.11596; hf].  12L enc + 12L dec, d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206.  ``input_specs()`` provides precomputed audio frame
embeddings (the conformer speech frontend is stubbed per the assignment).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,       # decoder layers
    enc_layers=12,     # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    norm="layernorm",
    rope_theta=10000.0,
    frontend="frames",
    frontend_dim=1024,
    citation="[arXiv:2308.11596; hf]",
)
