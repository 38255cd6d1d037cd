"""A cell's weights, drawn on the device from the run's seed.

Each layer is one draw: a ``torch.Generator`` on the device, seeded from
the run's seed and the layer's index, fills one flat buffer in the served
type, and the layer's leaves are views of it, each scaled in place.  So
the program and the reference see the same numbers, and the reference can
draw any layer again on its own, after the program's copy is gone.

Scales: a matrix stored ``(in, out)`` draws at ``1/sqrt(in)``, the
embedding at 1 (a row is a token's vector), a norm's scale at 0.1 (the
norm multiplies by ``1 + scale``)."""
from __future__ import annotations

import math

import torch

from .shape import Shape

TOP = -1          # the index of the embedding, unembedding and final norm


def layer_seed(seed: int, layer: int) -> int:
    """The generator seed of ``layer`` (``TOP`` for the top leaves)."""
    return (int(seed) * 1_000_003 + layer + 7) % (1 << 62)


def _scale(name: str, shape: tuple) -> float:
    if len(shape) == 1:
        return 0.1
    if name == "embed":
        return 1.0
    return 1.0 / math.sqrt(shape[-2])


def draw(leaves: dict, seed: int, layer: int, device,
         dtype=torch.bfloat16) -> dict:
    """The leaves ``{name: shape}`` of one layer → ``{name: tensor}``,
    views of one buffer drawn from ``layer_seed(seed, layer)``."""
    sizes = {n: math.prod(s) for n, s in leaves.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(layer_seed(seed, layer))
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device,
                       dtype=dtype)
    out, at = {}, 0
    for name, shape in leaves.items():
        t = flat[at:at + sizes[name]].view(shape)
        t.mul_(_scale(name, shape))
        out[name] = t
        at += sizes[name]
    return out


def draw_layer(s: Shape, seed: int, layer: int, device) -> dict:
    return draw(s.block_leaves(), seed, layer, device,
                getattr(torch, s.dtype))


def draw_top(s: Shape, seed: int, device) -> dict:
    return draw(s.top_leaves(), seed, TOP, device, getattr(torch, s.dtype))


@torch.no_grad()
def fill_program(model, s: Shape, seed: int) -> None:
    """Copy the seeded weights into the program's parameter tree (its
    leaves by the names of :meth:`Shape.block_leaves`), a layer at a
    time."""
    dev = model.device
    for name, t in draw_top(s, seed, dev).items():
        getattr(model, name).copy_(t)
    for layer, blk in enumerate(model.blocks):
        for name, t in draw_layer(s, seed, layer, dev).items():
            getattr(blk, name).copy_(t)
