"""Carry the reference's parameters across to the port's model.

The reference's parameter tree, as numpy arrays
(``jax.tree.map(np.asarray, zoo.init_model(cfg, key))``), keeps the layers
stacked: ``layers/attn/wq/w`` is ``[L, d, H*hd]`` and a MoE layer's
``layers/moe/w_gate`` is ``[L, E, d, ff]``.  The port's module attributes
carry the tree's keys, so ``layers/<rest>`` of layer ``i`` is the
state-dict entry ``layers.<i>.<rest>`` (and DeepSeek's
``dense_layers/<rest>`` is ``dense_layers.<i>.<rest>``; an SSM layer's
``layers/mamba/A_log`` is ``[L, d_inner, N]``), and every other leaf
``a/b`` is ``a.b`` (Zamba2's unstacked ``shared_attn/attn/wq/w`` is
``shared_attn.attn.wq.w``).  An encoder-decoder's ``enc_layers/<rest>`` and
``dec_layers/<rest>`` (``cross/*`` and ``ln_x`` among them) are stacked
over the encoder's and the decoder's layers likewise, and its
``enc_norm`` and the VLM's ``projector/fc1/w`` are leaves as any other.
Values are copied exactly (bf16 passes through f32 losslessly).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models.layers import torch_dtype
from repro_torch.models.zoo import Model, _n_dense_layers


def _flatten(tree: Any, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flatten(sub, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def params_from_numpy(cfg: ArchConfig, tree: dict, *, device) -> Model:
    """The port's model holding the values of the reference tree ``tree``.
    Raises ``ValueError`` on a missing or extra leaf or a shape that does
    not match."""
    dev = resolve_device(device)
    model = Model(cfg, device="meta")
    want = {name: tuple(t.shape) for name, t in model.state_dict().items()}
    n_dense = _n_dense_layers(cfg)
    stacked = ({"enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}
               if cfg.is_encdec else
               {"layers": cfg.n_layers - n_dense, "dense_layers": n_dense})
    got = {}
    for name, leaf in _flatten(tree).items():
        arr = np.asarray(leaf)
        stack, _, rest = name.partition("/")
        if stack in stacked and rest:
            n = stacked[stack]
            if arr.ndim < 1 or arr.shape[0] != n:
                raise ValueError(f"{name}: {arr.shape} is not stacked over "
                                 f"{n} layers")
            for i in range(n):
                got[f"{stack}.{i}.{rest.replace('/', '.')}"] = arr[i]
        else:
            got[name.replace("/", ".")] = arr
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {missing}, extra {extra}")
    for name, arr in got.items():
        if tuple(arr.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the model "
                             f"has {want[name]}")
    dt = torch_dtype(cfg.param_dtype)
    state = {name: torch.from_numpy(np.array(arr, dtype=np.float32))
             .to(device=dev, dtype=dt) for name, arr in got.items()}
    model = model.to_empty(device=dev)
    model.load_state_dict(state, strict=True)
    return model
