"""Falcon-Mamba-7B [ssm] — Mamba-1 architecture, attention-free.

[arXiv:2410.05355; unverified].  64L d_model=4096 d_ff=0 vocab=65024,
ssm_state=16, d_inner=2*d=8192, conv=4, dt_rank=ceil(4096/16)=256.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=65024,
    norm="rmsnorm",
    ssm=SSMConfig(
        kind="mamba1",
        d_state=16,
        d_conv=4,
        expand=2,
        chunk=256,
        dt_rank=256,
    ),
    citation="[arXiv:2410.05355; unverified]",
)
