"""The system under test: the only module of the harness besides ``loops/``
that imports the program (``repro_torch``).

It builds the program's serving config from a configuration file, checks
that the program's model has exactly the parameters the benchmark draws
(``reference/lm.py::layout``), and installs the benchmark's seeded weights
in it without a copy: the program serves the very tensors the benchmark
drew, and the reference draws them again when it needs them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from modelspec import run_value
from reference import lm


def program_config(config: dict, *, compute_dtype: str = "bfloat16"):
    """The program's serving config (``make_serve_config`` on one device:
    bf16 weights) for ``config``, with every size taken from the file."""
    from repro_torch.configs.base import get_config, make_serve_config

    c = config
    base = make_serve_config(get_config(c["arch"]), model_axis=1)
    d, h = c["hidden_size"], c["num_attention_heads"]
    kw = dict(n_layers=c["num_hidden_layers"], d_model=d, n_heads=h,
              n_kv_heads=c.get("num_key_value_heads", h),
              head_dim=c.get("head_dim") or d // h,
              d_ff=c["intermediate_size"], vocab=c["vocab_size"],
              rope_theta=float(c["rope_theta"]),
              compute_dtype=compute_dtype)
    if base.frontend == "patch":
        kw.update(frontend_dim=c["vision_hidden_size"],
                  frontend_tokens=run_value(c, "num_image_token"))
    if base.moe is not None:
        ff = c["moe_intermediate_size"]
        kw["d_ff"] = ff
        kw["moe"] = dataclasses.replace(
            base.moe, n_routed=c["n_routed_experts"],
            top_k=c["num_experts_per_tok"], d_expert_ff=ff,
            n_shared=c["n_shared_experts"], d_shared_ff=ff,
            capacity_factor=float(run_value(c, "capacity_factor")),
            first_dense_layers=c["first_k_dense_replace"],
            d_first_dense_ff=c["intermediate_size"])
    if base.mla is not None:
        kw["mla"] = dataclasses.replace(
            base.mla, kv_lora_rank=c["kv_lora_rank"],
            qk_nope_head_dim=c["qk_nope_head_dim"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            v_head_dim=c["v_head_dim"], q_lora_rank=c["q_lora_rank"] or 0)
    return dataclasses.replace(base, **kw)


def build_model(cfg, weights: lm.Weights):
    """The program's model for ``cfg`` holding ``weights``' tensors (drawn
    on ``weights.device``, one draw per group).  Raises if the program's
    parameters differ from the benchmark's layout in name, shape or
    dtype."""
    from repro_torch.models.zoo import Model

    model = Model(cfg, device="meta")
    have = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    want = {name: (shape, lm.DTYPE) for _, entries in weights.groups
            for name, shape, _ in entries}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise RuntimeError(f"{cfg.name}: the program's parameters differ "
                           f"from the benchmark's layout: {diff}")
    if any(True for _ in model.buffers()):
        raise RuntimeError(f"{cfg.name}: the model holds buffers the "
                           f"benchmark does not draw")
    for group, _ in weights.groups:
        for name, t in weights.draw(group).items():
            owner, _, leaf = name.rpartition(".")
            model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
                t, requires_grad=False)
    return model


def launch_counts() -> dict:
    """The program's own launch counters of the kernels the cells drive."""
    from repro_torch.kernels import decode, flash_attention

    return {"flash_attention": flash_attention.LAUNCHES.count,
            "decode_gop_blocks": decode.LAUNCHES.count}
