"""Production mesh description and the card's published peaks.

Counterpart of the reference's ``launch/mesh.py``, retargeted from a
16x16 TPU v5e slice to one 80 GB NVIDIA H100.  The port runs on one
device and builds no device mesh: ``make_production_mesh`` returns a
:class:`Mesh` that only describes the layout, with ``.shape`` ({axis:
size}) and ``.axis_names`` as a ``jax.sharding.Mesh`` has them, which is
all ``analytic_cost.hbm_bytes_per_chip`` and ``dryrun`` read.  A mesh of
more than one device, or over pods, is refused: sharding
(``distributed/``) is not ported (ROADMAP, queue 1 item 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field

MESH_REFUSED = ("a mesh of more than one device: sharding is not ported; "
                "the port runs on one H100 (ROADMAP, queue 1 item 9, "
                "distributed/)")


@dataclass(frozen=True)
class Mesh:
    """The layout of the devices a step runs on: ``shape`` maps each axis
    name to its size, in the order of ``axis_names``.  Only one device is
    taken: a larger mesh raises ``NotImplementedError``."""

    axis_names: tuple = ("data", "model")
    sizes: tuple = (1, 1)
    shape: dict = field(init=False, compare=False)

    def __post_init__(self):
        if self.size != 1:
            raise NotImplementedError(
                f"mesh {dict(zip(self.axis_names, self.sizes))}: "
                f"{MESH_REFUSED}")
        object.__setattr__(self, "shape",
                           dict(zip(self.axis_names, self.sizes)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False, pods: int = 2) -> Mesh:
    """One H100 with axes ``data=1`` and ``model=1``.  ``multi_pod`` (a
    mesh over ``pods`` pods) raises ``NotImplementedError`` naming ROADMAP
    queue 1 item 9, as any mesh larger than 1x1 does."""
    if multi_pod:
        raise NotImplementedError(
            f"make_production_mesh(multi_pod=True, pods={pods}): "
            f"{MESH_REFUSED}")
    return Mesh()


# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
# no sparsity), which assume the card's full power limit of 700 W; a card
# set below it runs slower under load, so a share against these names the
# card's limit beside it.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s of HBM3
LINK_BW = 450e9               # bytes/s of NVLink, each way
HBM_PER_CHIP = 80e9           # bytes of HBM3
