"""Sharding rules of the port, the JAX package's ``repro.dist.sharding``
over ``torch.distributed`` meshes.

One convention everywhere (mesh axes ``("data", "model")`` per pod, plus a
leading ``"pod"`` axis multi-pod):

  * parameters    — tensor-parallel over ``"model"``: the largest trailing
    dim divisible by the axis size is sharded; ZeRO-1 optimizer moments are
    additionally sharded over the data-parallel axes;
  * batches       — leading (batch) dim over the data-parallel axes;
  * decode state  — KV caches / recurrent states are ``(L, B, …)``; the
    batch dim (axis 1) is sharded over the data-parallel axes;
  * activations   — the residual stream is redistributed to batch sharding
    by :func:`constrain_residual`, the identity until a mesh is installed
    with :func:`set_activation_mesh`.

A rule takes a ``DeviceMesh`` or a :class:`~repro_torch.launch.mesh.
MeshShape` (axis names and sizes alone, no process group) and a tree of
leaves with a ``.shape`` (``TensorSpec``\\ s, tensors), and gives the same
tree of :class:`NamedSharding`\\ s.  Each carries a :class:`PartitionSpec`
that equals the JAX package's spec entry for entry (and prints as it
does), and the DTensor placements derived from it, one a mesh dimension.
A dim that does not divide the axis size stays replicated, so the same
rules hold on a 1×1 test mesh and on the 16×16 production mesh.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.mesh import MeshShape

_ACTIVATION_MESH = None


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dim sharded over their product, the first
    major), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


P = PartitionSpec


def mesh_shape(mesh) -> MeshShape:
    """The axis names and sizes of a ``DeviceMesh`` (or a MeshShape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh (a ``DeviceMesh`` or a
    MeshShape)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dimension: ``Shard(d)`` where
        the spec names that mesh axis at tensor dim ``d``, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in mesh_shape(self.mesh).axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (``None``
    is an empty subtree, as in ``jax.tree``); ``rest`` are trees of the
    same structure whose leaves go along."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def set_activation_mesh(mesh) -> None:
    """Install the ``DeviceMesh`` used by :func:`constrain_residual`
    (None to clear)."""
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh


def _data_axes(shape: MeshShape) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shape.axis_names)


def _axes_size(shape: MeshShape, axes: tuple) -> int:
    return math.prod(shape.shape[a] for a in axes) if axes else 1


def _data_entry(daxes: tuple):
    return daxes if len(daxes) > 1 else daxes[0]


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def constrain_residual(x):
    """Redistribute a residual-stream DTensor (B, …) to batch sharding.

    Identity when no mesh is installed, the mesh is trivial, the batch
    dim does not divide the data-parallel extent (e.g. unit-batch decode),
    or ``x`` is a plain tensor (one device's activations).
    """
    from torch.distributed.tensor import DTensor
    mesh = _ACTIVATION_MESH
    if mesh is None or x.ndim < 1:
        return x
    shape = mesh_shape(mesh)
    if shape.size == 1:
        return x
    daxes = _data_axes(shape)
    dp = _axes_size(shape, daxes)
    if dp <= 1 or x.shape[0] % dp != 0 or not isinstance(x, DTensor):
        return x
    spec = [None] * x.ndim
    spec[0] = _data_entry(daxes)
    return x.redistribute(mesh, NamedSharding(mesh, P(*spec)).placements)


def _shard_one_dim(shape, axis_n, *, reverse=True, taken=()):
    """Pick the dim to shard over an axis of size ``axis_n`` (or None)."""
    if axis_n <= 1:
        return None
    dims = range(len(shape) - 1, -1, -1) if reverse else range(len(shape))
    for i in dims:
        if i not in taken and shape[i] % axis_n == 0 and shape[i] >= axis_n:
            return i
    return None


def param_shardings(cfg, specs, mesh, *, zero: bool = False):
    """NamedSharding tree for a param (or moment) spec tree.

    Tensor-parallel over ``"model"`` on the largest-index divisible dim
    (skipping the leading layer-stack dim of stacked block params); with
    ``zero=True`` (ZeRO-1 moments) an additional dim is sharded over the
    data-parallel axes.
    """
    shape = mesh_shape(mesh)
    model_n = shape.shape.get("model", 1)
    daxes = _data_axes(shape)
    dp = _axes_size(shape, daxes)

    def one(s):
        spec = [None] * len(s.shape)
        # never shard the layer-stack dim (dim 0 of >= 3-D block params
        # equals n_layers); trailing dims are the matmul dims
        mi = _shard_one_dim(s.shape, model_n,
                            taken=(0,) if len(s.shape) > 2 else ())
        if mi is not None:
            spec[mi] = "model"
        if zero and dp > 1:
            zi = _shard_one_dim(s.shape, dp, reverse=False,
                                taken=() if mi is None else (mi,))
            if zi is not None:
                spec[zi] = _data_entry(daxes)
        return NamedSharding(mesh, P(*spec))

    return tree_map(one, specs)


def batch_sharding(mesh, specs):
    """Shard the leading (batch) dim of every input leaf over data axes."""
    shape = mesh_shape(mesh)
    daxes = _data_axes(shape)
    dp = _axes_size(shape, daxes)

    def one(s):
        spec = [None] * len(s.shape)
        if s.shape and dp > 1 and s.shape[0] % dp == 0:
            spec[0] = _data_entry(daxes)
        return NamedSharding(mesh, P(*spec))

    return tree_map(one, specs)


def decode_state_shardings(cfg, specs, mesh):
    """Decode-state leaves are (L, B, …): shard batch (axis 1) over data
    axes and, when divisible, the head dim (axis 2) over ``"model"``."""
    shape = mesh_shape(mesh)
    model_n = shape.shape.get("model", 1)
    daxes = _data_axes(shape)
    dp = _axes_size(shape, daxes)

    def one(s):
        spec = [None] * len(s.shape)
        if len(s.shape) > 1 and dp > 1 and s.shape[1] % dp == 0:
            spec[1] = _data_entry(daxes)
        if len(s.shape) > 2 and model_n > 1 and s.shape[2] % model_n == 0:
            spec[2] = "model"
        return NamedSharding(mesh, P(*spec))

    return tree_map(one, specs)
