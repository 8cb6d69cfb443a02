"""The LM launchers of the port: ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.serve`` (counterparts of the
reference's ``launch/train.py`` and ``launch/serve.py``)."""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels.decode.ops import resolve_device
from repro_torch.models import init_model


def init_on_device(cfg, device: str, prog: str):
    """``cfg``'s model with random weights on ``device`` (``cuda``,
    ``cuda:N`` or ``cpu``); None, with the reason on standard error after
    ``prog``, where a CUDA device is asked for and there is none.  On a
    card the weights are drawn there from a CUDA generator seeded with 0
    (a host draw of a full-width model takes a while), on the CPU from
    seed 0."""
    try:
        dev = resolve_device(device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"{prog}: {e}", file=sys.stderr, flush=True)
        return None
    gen = (torch.Generator(device=dev).manual_seed(0) if dev.type == "cuda"
           else 0)
    return init_model(cfg, gen, device=dev)
