"""SmolLM-135M [dense] — llama-arch small, GQA kv=3.

[hf:HuggingFaceTB/SmolLM-135M; hf].  30L d_model=576 9H d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    citation="[hf:HuggingFaceTB/SmolLM-135M; hf]",
)
