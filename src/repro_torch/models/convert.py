"""Carry parameters between the JAX package's tree and the port's
:class:`~repro_torch.models.transformer.Transformer`, both ways.

The tree is ``{"embed", "unembed", "final_norm", "blocks": {...}}`` with
the blocks stacked on a leading layer axis, as
``repro.models.transformer.init_params`` makes it.  Its leaves are numpy
arrays (pass each JAX leaf through ``np.asarray``) or CPU tensors (what
``repro_torch.train.checkpoint.restore_checkpoint`` gives).  A bfloat16
numpy leaf is an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
refuses; it is carried through its ``uint16`` bits, so every value
arrives exactly, and goes back the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Transformer, block_shapes, top_shapes


def tensor_from_numpy(x) -> torch.Tensor:
    """A numpy array (float32, float16 or ml_dtypes bfloat16) → a CPU
    tensor with the same values and type; a tensor passes through."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.array(x)                       # a writable, contiguous copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


@torch.no_grad()
def load_params_(cfg: ModelConfig, model: Transformer, tree: dict) -> None:
    """Copy the tree's leaves into ``model``'s parameters in place (their
    device and type), leaf for leaf; a shape that differs raises."""
    for name, shape in top_shapes(cfg).items():
        t = tensor_from_numpy(tree[name])
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        getattr(model, name).copy_(t)
    blocks = tree["blocks"]
    for name, shape in block_shapes(cfg).items():
        t = tensor_from_numpy(blocks[name])
        if tuple(t.shape) != (cfg.n_layers, *shape):
            raise ValueError(f"blocks.{name}: shape {tuple(t.shape)}, want "
                             f"{(cfg.n_layers, *shape)}")
        for layer, blk in enumerate(model.blocks):
            getattr(blk, name).copy_(t[layer])


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device=None) -> Transformer:
    """The JAX parameter tree → a Transformer on ``device`` (the card
    unless named), leaf for leaf, in ``cfg``'s type."""
    model = Transformer(cfg, device)
    load_params_(cfg, model, tree)
    return model


@torch.no_grad()
def params_tree(cfg: ModelConfig, model: Transformer) -> dict:
    """``model`` → the JAX package's tree of CPU tensors in the model's
    type, each block leaf stacked over the layers."""
    tree = {name: getattr(model, name).detach().cpu()
            for name in top_shapes(cfg)}
    tree["blocks"] = {name: torch.stack([getattr(blk, name).detach().cpu()
                                         for blk in model.blocks])
                      for name in block_shapes(cfg)}
    return tree


def tensor_to_numpy(t: torch.Tensor, bfloat16=None) -> np.ndarray:
    """A CPU tensor → a numpy array of the same values and type.  numpy
    has no bfloat16: a bfloat16 tensor's bits are viewed as ``bfloat16``,
    a numpy dtype the caller names (``ml_dtypes.bfloat16``), and without
    one it raises."""
    if t.dtype != torch.bfloat16:
        return t.numpy()
    if bfloat16 is None:
        raise ValueError("a bfloat16 leaf needs bfloat16= (a numpy dtype "
                         "such as ml_dtypes.bfloat16)")
    return t.view(torch.int16).numpy().view(bfloat16)


def params_to_numpy(cfg: ModelConfig, model: Transformer,
                    bfloat16=None) -> dict:
    """``model`` → the JAX package's numpy tree: the same names, shapes,
    types and values as the tree ``params_from_numpy`` takes."""
    tree = params_tree(cfg, model)
    out = {name: tensor_to_numpy(tree[name], bfloat16)
           for name in top_shapes(cfg)}
    out["blocks"] = {name: tensor_to_numpy(t, bfloat16)
                     for name, t in tree["blocks"].items()}
    return out
