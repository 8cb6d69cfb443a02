"""The model families' training inputs, shared by the CPU tests, the card
tests and ``chip_smoke.py``'s family train phase (which loads this file by
path): one architecture of each family of the zoo, a reduced config with
head widths the attention kernels take, a batch laid out as
``input_specs`` lays it out, and the attention calls of one forward.
Imports neither JAX nor a package of the repository (numpy alone): the
functions take either package's ``ArchConfig``."""
import dataclasses

import numpy as np

#: one architecture of each family of the zoo
FAMILIES = {"dense": "smollm-135m", "moe": "qwen3-moe-30b-a3b",
            "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b",
            "mla": "deepseek-v2-lite-16b", "encdec": "seamless-m4t-medium",
            "vlm": "internvl2-26b"}


def kernel_widths(cfg, dtype: str):
    """``cfg`` (a ``reduce_config``) with head widths the kernels take
    (64 for the encoder-decoder, 128 for the rest, MLA's published q.k
    128 + 64 over v 128, as ``scripts/smoke_models_torch.py`` widens
    them) and its params and compute in ``dtype``."""
    kw = {"head_dim": 64 if cfg.is_encdec else 128, "param_dtype": dtype,
          "compute_dtype": dtype}
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, qk_nope_head_dim=128,
                                        qk_rope_head_dim=64, v_head_dim=128)
    return dataclasses.replace(cfg, **kw)


def batch(cfg, b: int, s: int, rng, frames=None) -> dict:
    """numpy tokens and targets (int32) of S positions, with the VLM's S /
    4 patch embeddings ahead of S - S / 4 tokens, or the encoder-decoder's
    ``frames`` (S / 4 unless given) frame embeddings."""
    out, n_text = {}, s
    if cfg.frontend == "patch":
        n_img = min(cfg.frontend_tokens, s // 4)
        out["patch_embeds"] = rng.standard_normal(
            (b, n_img, cfg.frontend_dim), dtype=np.float32)
        n_text = s - n_img
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, frames or s // 4, cfg.d_model), dtype=np.float32)
    toks = rng.integers(0, cfg.vocab, (b, n_text + 1), dtype=np.int32)
    out["tokens"], out["targets"] = toks[:, :-1], toks[:, 1:]
    return out


def attention_sites(cfg) -> int:
    """The attention calls of one forward, so the backward kernel's
    launches a training step: one a layer, none in the SSM family, the
    hybrid's shared-block sites, the encoder's layers and two a decoder
    layer (self- and cross-attention)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.shared_attn_every
    if cfg.is_encdec:
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers
