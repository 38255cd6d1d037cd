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
:func:`init_` draws a tree: an ``int`` seed as the JAX package's
``jax.random`` does (:mod:`prng`), a ``torch.Generator`` its own
numbers.

Parameters are created frozen (``requires_grad`` false), so the serving
paths build no autograd graph; a trainer calls ``model.requires_grad_()``
on its own model.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Callable

import numpy as np
import torch
from torch import nn

from . import prng


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


@dataclasses.dataclass(frozen=True)
class Normal:
    """A rule's normal draw.  The JAX package's draw is scaled by its
    float32 ``x * c`` (``op`` "mul") or ``x / c`` ("div"); a torch
    Generator's draw is multiplied by ``scale``, a Python float."""
    op: str
    c: float
    scale: float


def times(v: float) -> Normal:
    """A normal draw times the constant ``v``."""
    return Normal("mul", float(np.float32(v)), v)


def fan_in(tree_shape: tuple, op: str) -> Normal:
    """A normal draw scaled by 1/sqrt(fan_in), with the JAX package's
    fan-in: the second-to-last dimension of the leaf's tree shape (a
    stacked leaf's with its layer axis), the last for a 1-D leaf.
    ``op`` is how the family's JAX init writes it: "mul" for
    ``x * (1 / sqrt(fan_in))``, "div" for ``x / sqrt(fan_in)`` (the root
    taken as XLA takes it, :func:`prng.xla_sqrt`)."""
    n = tree_shape[-2] if len(tree_shape) >= 2 else tree_shape[-1]
    root = prng.xla_sqrt(torch.tensor([float(n)], dtype=torch.float32))
    c = root if op == "div" else 1.0 / root
    return Normal(op, float(c), n ** -0.5)


def _jax_order(model: ParamTree):
    """``(name, tree_shape, params)`` of every leaf in the order
    ``jax.tree_util`` flattens the JAX package's tree (sorted keys)."""
    for name in sorted(model.layout):
        item = model.layout[name]
        if isinstance(item, Stack):
            for k in sorted(item.shapes):
                yield (k, (item.n, *item.shapes[k]),
                       [getattr(blk, k) for blk in getattr(model, name)])
        elif isinstance(item, dict):
            sub = getattr(model, name)
            for k in sorted(item):
                yield k, tuple(item[k]), [getattr(sub, k)]
        else:
            yield name, tuple(item), [getattr(model, name)]


def _init_jax(model: ParamTree, seed: int, rule: Callable) -> None:
    """Draw ``model`` as the JAX package's ``init_params(cfg,
    PRNGKey(seed))`` does: one key a leaf from ``split``, a stacked
    leaf's layer ``j`` the elements ``[j·n, (j + 1)·n)`` of its draw, in
    chunks of :func:`prng.chunk` elements on the parameters' device."""
    order = list(_jax_order(model))
    keys = prng.split(prng.prng_key(seed), len(order))
    for key, (name, tree_shape, params) in zip(keys, order):
        value = rule(name, tree_shape)
        for j, param in enumerate(params):
            if callable(value):
                param.copy_(value(tuple(param.shape)))
                continue
            flat = param.view(-1)
            n = flat.numel()
            c = torch.tensor(value.c, dtype=torch.float32,
                             device=param.device)
            step = prng.chunk(param.device)
            for a in range(0, n, step):
                x = prng.normal(key, j * n + a, min(step, n - a),
                                param.device)
                flat[a:a + x.numel()].copy_(x * c if value.op == "mul"
                                            else x / c)


@contextlib.contextmanager
def _one_thread():
    """PyTorch's CPU ops on one thread while the block runs.  A seeded
    draw is a chain of hundreds of small elementwise ops a chunk; split
    over threads, each op waits for every thread, and where processes
    share the cores (test workers, several servers on a host) those
    waits take many times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@torch.no_grad()
def init_(model: ParamTree, generator: torch.Generator | int,
          rule: Callable) -> ParamTree:
    """Fill ``model`` at random on its device.  ``rule(name,
    tree_shape)`` gives a leaf's value: a :class:`Normal` draw, or a
    callable that maps one parameter's shape to its float32 value (a
    constant).

    An ``int`` seed draws what the JAX package's ``jax.random`` draws for
    ``PRNGKey(seed)`` (:mod:`prng`).  A ``torch.Generator`` draws its own
    numbers: every parameter draws its normal in layout order (a stack's
    layers outer, its leaves inner), constants too, so a rule that turns
    a leaf constant leaves the other leaves' numbers as they were."""
    if not isinstance(generator, torch.Generator):
        if model.device.type == "cpu":
            with _one_thread():
                _init_jax(model, int(generator), rule)
        else:
            _init_jax(model, int(generator), rule)
        return model
    dev = model.device
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
            x.mul_(value.scale)
        param.copy_(x)
    return model
