"""The LM launchers of the port: ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.serve`` (counterparts of the
reference's ``launch/train.py`` and ``launch/serve.py``), and what they
share: the model drawn on the device, the ``--mesh`` they run on."""
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


#: the families a mesh of more than one rank trains and serves
MESH_FAMILIES = ("dense", "moe")
MESH_FAMILY_REFUSED = (
    "{name} ({family}) on a mesh of {size} ranks: a mesh past 1x1 trains "
    "and serves the dense and MoE families only; the others are what is "
    "left of ROADMAP queue 1 item 9")


def printer(mesh):
    """``print``, flushed, on rank 0 of ``mesh``'s world only (on every
    run without a mesh)."""
    import torch.distributed as dist

    quiet = mesh is not None and dist.get_rank() != 0

    def say(line: str) -> None:
        if not quiet:
            print(line, flush=True)

    return say


def setup_mesh(ap, args, cfg, prog: str):
    """The mesh of ``--mesh D,M`` over the run's ranks
    (``launch.mesh.init_mesh``, on ``--device``'s type), None without
    ``--mesh``, or False, with the reason on standard error, where a CUDA
    device is asked for and there is none.  A family outside
    :data:`MESH_FAMILIES` on a mesh of more than one rank, or a mesh that
    is not the world's size, ends the run through ``ap.error``."""
    if not args.mesh:
        return None
    from repro_torch.launch.mesh import init_mesh

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"{prog}: {e}", file=sys.stderr, flush=True)
        return False
    dims = tuple(int(x) for x in args.mesh.split(","))
    size = 1
    for d in dims:
        size *= d
    if size > 1 and cfg.family not in MESH_FAMILIES:
        ap.error(MESH_FAMILY_REFUSED.format(name=cfg.name, family=cfg.family,
                                            size=size))
    try:
        return init_mesh(dims, dev.type)
    except ValueError as e:  # the mesh is not the world's size
        ap.error(f"--mesh {args.mesh}: {e}")
