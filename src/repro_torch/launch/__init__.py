"""The LM launchers of the port: ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.serve`` (counterparts of the
reference's ``launch/train.py`` and ``launch/serve.py``), and what they
share: the model drawn on the device, the ``--mesh`` they run on, the
``--layers`` cut of depth."""
from __future__ import annotations

import dataclasses
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


def cut_depth(ap, cfg, layers: int):
    """``cfg`` with its first ``layers`` layers (``--layers``; 0 keeps
    them all); more than it has ends the run through ``ap.error``."""
    if not layers:
        return cfg
    if not 0 < layers <= cfg.n_layers:
        ap.error(f"--layers {layers}: {cfg.name} has {cfg.n_layers} layers")
    return dataclasses.replace(cfg, n_layers=layers)


def printer(mesh):
    """``print``, flushed, on rank 0 of ``mesh``'s world only (on every
    run without a mesh)."""
    import torch.distributed as dist

    quiet = mesh is not None and dist.get_rank() != 0

    def say(line: str) -> None:
        if not quiet:
            print(line, flush=True)

    return say


def setup_mesh(ap, args, prog: str):
    """The mesh of ``--mesh D,M`` over the run's ranks
    (``launch.mesh.init_mesh``, on ``--device``'s type), None without
    ``--mesh``, or False, with the reason on standard error, where a CUDA
    device is asked for and there is none.  Every family the launcher
    runs takes a mesh, as in the reference (each leaf placed by
    ``param_pspec``, its layers' tensor parallelism in
    ``distributed/parallel.py``); a mesh that is not the world's size
    ends the run through ``ap.error``."""
    if not args.mesh:
        return None
    from repro_torch.launch.mesh import init_mesh

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"{prog}: {e}", file=sys.stderr, flush=True)
        return False
    dims = tuple(int(x) for x in args.mesh.split(","))
    try:
        return init_mesh(dims, dev.type)
    except ValueError as e:  # the mesh is not the world's size
        ap.error(f"--mesh {args.mesh}: {e}")
