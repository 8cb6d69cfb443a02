"""InternVL2-26B [vlm] — InternViT frontend (stub) + InternLM2-20B backbone.

[arXiv:2404.16821; hf].  Backbone: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553.  The ViT frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings (InternViT-6B width 3200); a 2-layer
MLP projector maps them into the LM space (first-class, trained).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    norm="rmsnorm",
    rope_theta=1000000.0,
    frontend="patch",
    frontend_dim=3200,
    frontend_tokens=1024,
    citation="[arXiv:2404.16821; hf]",
)
