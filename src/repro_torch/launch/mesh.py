"""Production meshes of the port, over ``torch.distributed``.

The JAX package's ``make_production_mesh`` is a (16, 16) ``("data",
"model")`` mesh of 256 chips a pod, and (2, 16, 16) with a leading
``"pod"`` axis for two pods; ``make_mesh`` builds any other shape (the
fault-tolerance path re-forms smaller meshes).  Here each builds a
``DeviceMesh`` over the process group the caller has initialised, and
raises when the world does not have exactly the mesh's ranks: a mesh is
never shrunk to fit.  :class:`MeshShape` is a mesh's axis names and sizes
alone, with no process group, which is all the sharding rules
(:mod:`repro_torch.dist.sharding`) read.  Like the JAX package's, these
are functions, so importing this module touches no device and no group.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

#: the JAX package's production shapes and axis names, by ``multi_pod``
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's sizes and axis names, without devices: ``shape`` maps
    each axis name to its size, in axis order, as a JAX mesh's does."""
    sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape and axis names, with no group."""
    return MeshShape(*PRODUCTION[multi_pod])


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    default process group, on the cards under NCCL and on the CPU
    otherwise.  Raises unless the world has exactly ``prod(shape)``
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    want = MeshShape(tuple(shape), tuple(axes))
    if not dist.is_initialized():
        raise RuntimeError(f"a {want.sizes} mesh needs an initialised "
                           f"process group of {want.size} ranks")
    world = dist.get_world_size()
    if world != want.size:
        raise ValueError(f"a {want.sizes} {want.axis_names} mesh needs "
                         f"{want.size} ranks; the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, want.sizes,
                            mesh_dim_names=want.axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    want = production_shape(multi_pod=multi_pod)
    return make_mesh(want.sizes, want.axis_names)
