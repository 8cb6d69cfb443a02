"""Meshes: described for the dry run, or built over ranks; the card's
published peaks.

Counterpart of the reference's ``launch/mesh.py``, retargeted from a
16x16 TPU v5e slice to NVIDIA H100s.  A :class:`Mesh` has ``.shape``
({axis: size}) and ``.axis_names`` as a ``jax.sharding.Mesh`` has them,
which is all ``analytic_cost.hbm_bytes_per_chip``, ``dryrun`` and the
spec functions of ``distributed/sharding.py`` read, so a mesh can be
described at any size (the reference's 16x16 and 2x16x16 layouts) to
evaluate specs.  :func:`init_mesh` builds one over the ranks of a
``torch.distributed`` world: its ``device_mesh`` is the ``DeviceMesh``
that the port's sharded steps run on, NCCL for ``cuda``, gloo for
``cpu``.  One card makes a 1x1 mesh.  ``make_production_mesh`` describes
the one-card layout, the reference's 16x16 pod (``pod=True``) or its
``(pods, 16, 16)`` layout over pods (``multi_pod=True``).  A dry run over
such a mesh walks rank 0 of it in one process: :func:`fake_world` opens
torch's ``fake`` process-group backend at rank 0 of ``mesh.size`` ranks,
whose collectives complete without moving data, so a step placed over
the whole mesh runs on ``meta`` tensors (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """The layout of the devices a step runs on: ``shape`` maps each axis
    name to its size, in the order of ``axis_names``.  ``device_mesh`` is
    the ``DeviceMesh`` of a mesh built over ranks (:func:`init_mesh`), or
    None for a mesh only described."""

    axis_names: tuple = ("data", "model")
    sizes: tuple = (1, 1)
    device_mesh: Optional[object] = field(default=None, compare=False)
    shape: dict = field(init=False, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} do not match")
        object.__setattr__(self, "shape",
                           dict(zip(self.axis_names, self.sizes)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


#: the reference's pod: a 16x16 slice over ``("data", "model")``
POD = (16, 16)


def make_production_mesh(*, multi_pod: bool = False, pods: int = 2,
                         pod: bool = False) -> Mesh:
    """A described mesh: one H100 with axes ``data=1`` and ``model=1``;
    with ``pod`` the reference's 16x16 over ``("data", "model")``; with
    ``multi_pod`` its ``(pods, 16, 16)`` over ``("pod", "data",
    "model")``.  None of them builds a device mesh (:func:`fake_world`
    does, to walk one)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (pods,) + POD)
    if pod:
        return Mesh(("data", "model"), POD)
    return Mesh()


@contextlib.contextmanager
def fake_world(mesh: Mesh):
    """Rank 0 of a world of ``mesh.size`` ranks on torch's ``fake``
    process-group backend, in this process: yields ``mesh`` with a
    ``DeviceMesh`` on ``cpu`` built over the world (rank-major, as
    :func:`init_mesh`), whose collectives complete at once and move no
    data, so a step placed over the mesh runs on ``meta`` tensors.  The
    group is destroyed on exit.  Refused when a process group is up
    already; it never falls back to gloo or NCCL."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"a fake world of {mesh.size} ranks needs no "
                           f"process group up; this process runs "
                           f"{dist.get_backend()}")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        dm = DeviceMesh("cpu", torch.arange(mesh.size).reshape(mesh.sizes),
                        mesh_dim_names=mesh.axis_names)
        yield Mesh(mesh.axis_names, mesh.sizes, dm)
    finally:
        dist.destroy_process_group()


def init_world(device_type: str) -> None:
    """Join (or make) the process group of this run.  Under ``torchrun``
    (``WORLD_SIZE`` set) it reads the launcher's environment; otherwise
    it makes a one-rank group from a ``FileStore`` in a temporary
    directory.  The backend follows the device: NCCL for ``cuda`` (which
    needs a card), gloo for ``cpu``; nothing falls back from one to the
    other.  A group that exists already is kept if its backend is the
    device's."""
    import torch.distributed as dist

    if device_type not in BACKENDS:
        raise ValueError(f"a mesh runs on cuda or cpu, not {device_type!r}")
    backend = BACKENDS[device_type]
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; there is "
                               "none (use device cpu for gloo)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in str(have):
            raise RuntimeError(f"the process group runs {have}; a "
                               f"{device_type} mesh needs {backend}")
        return
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(
        prefix="repro_torch_pg_"), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def init_mesh(dims, device_type: str = "cuda",
              axis_names: Optional[tuple] = None) -> Mesh:
    """A :class:`Mesh` of ``dims`` (e.g. ``(2, 4)``, axes ``("data",
    "model")``, or three dims with ``"pod"`` first) over the ranks of the
    world (:func:`init_world`), rank-major.  Its size must be the world's
    size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dims = tuple(int(d) for d in dims)
    names = tuple(axis_names or ("pod", "data", "model")[-len(dims):])
    init_world(device_type)
    world = dist.get_world_size()
    n = 1
    for d in dims:
        n *= d
    if n != world:
        raise ValueError(f"mesh {dims} holds {n} ranks; the world has "
                         f"{world}")
    dm = DeviceMesh(device_type, torch.arange(world).reshape(dims),
                    mesh_dim_names=names)
    return Mesh(names, dims, dm)


# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
# no sparsity), which assume the card's full power limit of 700 W; a card
# set below it runs slower under load, so a share against these names the
# card's limit beside it.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s of HBM3
LINK_BW = 450e9               # bytes/s of NVLink, each way
HBM_PER_CHIP = 80e9           # bytes of HBM3
