"""Parameter trees of the port's models: the JAX package's pytrees as
``nn.Module``s, shared by every family.

A family describes its tree with a *layout*, in the JAX package's names
and order (its ``param_specs``): a top-level leaf is a shape tuple;
``Stack(n, shapes)`` is a group of ``n`` layers whose leaves the JAX
package stacks on a leading layer axis and the port holds one
:class:`Leaves` module a layer, in an ``nn.ModuleList``; a dict is one
unstacked sub-tree (zamba2's ``shared`` block).  :class:`ParamTree`
builds the module of a layout, :func:`specs` the JAX tree of
:class:`TensorSpec` leaves, :func:`leaves` walks both together and
:func:`init_` draws a tree.

Parameters are created frozen (``requires_grad`` false), so the serving
paths build no autograd graph; a trainer calls ``model.requires_grad_()``
on its own model.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and type of a tensor (the counterpart of a
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Stack:
    """``n`` layers of the leaves ``shapes`` (each without the layer
    axis)."""
    n: int
    shapes: dict


def _frozen(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Leaves(nn.Module):
    """One layer's (or one sub-tree's) parameters, one attribute a leaf."""

    def __init__(self, shapes: dict, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, _frozen(shape, dtype, device))


class ParamTree(nn.Module):
    """The parameters of ``layout`` on ``device`` in ``dtype``, frozen
    until ``requires_grad_()``; the layout stays on the module."""

    def __init__(self, layout: dict, device, dtype):
        super().__init__()
        self.layout = layout
        for name, item in layout.items():
            if isinstance(item, Stack):
                setattr(self, name, nn.ModuleList(
                    Leaves(item.shapes, device, dtype)
                    for _ in range(item.n)))
            elif isinstance(item, dict):
                setattr(self, name, Leaves(item, device, dtype))
            else:
                setattr(self, name, _frozen(item, dtype, device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def specs(layout: dict, dtype: torch.dtype) -> dict:
    """The JAX package's parameter tree of ``layout`` as
    :class:`TensorSpec` leaves, each ``Stack`` leaf with its layer axis."""
    out = {}
    for name, item in layout.items():
        if isinstance(item, Stack):
            out[name] = {k: TensorSpec((item.n, *s), dtype)
                         for k, s in item.shapes.items()}
        elif isinstance(item, dict):
            out[name] = {k: TensorSpec(s, dtype) for k, s in item.items()}
        else:
            out[name] = TensorSpec(item, dtype)
    return out


def leaves(model: ParamTree):
    """Yield ``(path, tree_shape, params, stacked)`` for every leaf of the
    JAX tree: its key path, its shape there (a ``Stack`` leaf with the
    layer axis), the parameters that hold it (one a layer) and whether it
    is stacked."""
    for name, item in model.layout.items():
        if isinstance(item, Stack):
            for k, s in item.shapes.items():
                yield ((name, k), (item.n, *s),
                       [getattr(blk, k) for blk in getattr(model, name)],
                       True)
        elif isinstance(item, dict):
            sub = getattr(model, name)
            for k, s in item.items():
                yield (name, k), tuple(s), [getattr(sub, k)], False
        else:
            yield (name,), tuple(item), [getattr(model, name)], False


def fan_in_scale(tree_shape: tuple) -> float:
    """1/sqrt(fan_in) with the JAX package's fan-in: the second-to-last
    dimension of the leaf's tree shape (a stacked leaf's with its layer
    axis), the last for a 1-D leaf."""
    fan_in = tree_shape[-2] if len(tree_shape) >= 2 else tree_shape[-1]
    return fan_in ** -0.5


@torch.no_grad()
def init_(model: ParamTree, generator: torch.Generator | int,
          rule: Callable) -> ParamTree:
    """Fill ``model`` at random from ``generator`` (or a seed) on its
    device.  ``rule(name, tree_shape)`` gives a leaf's value: a float is
    the scale of a standard normal draw; a callable maps one parameter's
    shape to its float32 value (a constant).  Every parameter draws its
    normal in layout order (a stack's layers outer, its leaves inner),
    constants too, so a rule that turns a leaf constant leaves the other
    leaves' numbers as they were."""
    dev = model.device
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    order = []
    for name, item in model.layout.items():
        if isinstance(item, Stack):
            for blk in getattr(model, name):
                order += [(k, (item.n, *s), getattr(blk, k))
                          for k, s in item.shapes.items()]
        elif isinstance(item, dict):
            sub = getattr(model, name)
            order += [(k, tuple(s), getattr(sub, k)) for k, s in item.items()]
        else:
            order.append((name, tuple(item), getattr(model, name)))
    for name, tree_shape, param in order:
        x = torch.randn(param.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        value = rule(name, tree_shape)
        if callable(value):
            x = value(tuple(param.shape)).to(device=dev,
                                             dtype=torch.float32)
        else:
            x.mul_(value)
        param.copy_(x)
    return model
