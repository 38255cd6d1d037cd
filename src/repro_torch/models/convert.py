"""Carry parameters between the JAX package's tree and the port's models
(:class:`~repro_torch.models.params.ParamTree`), both ways, for every
family.

The tree is the JAX package's ``init_params`` tree of the config's
family: for the transformer ``{"embed", "unembed", "final_norm",
"blocks": {...}}`` with the blocks stacked on a leading layer axis;
rwkv's ``blocks``; zamba2's mamba ``blocks`` and its one ``shared``
block; whisper's ``enc_blocks``, ``dec_blocks``, positions and norms (the
model's ``layout`` names them).  Its leaves are numpy
arrays (pass each JAX leaf through ``np.asarray``) or CPU tensors (what
``repro_torch.train.checkpoint.restore_checkpoint`` gives).  A bfloat16
numpy leaf is an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
refuses; it is carried through its ``uint16`` bits, so every value
arrives exactly, and goes back the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from . import api
from . import params as P
from .config import ModelConfig


def tensor_from_numpy(x) -> torch.Tensor:
    """A numpy array (float32, float16 or ml_dtypes bfloat16) → a CPU
    tensor with the same values and type; a tensor passes through."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.array(x)                       # a writable, contiguous copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def load_params_(cfg: ModelConfig, model: P.ParamTree, tree: dict) -> None:
    """Copy the tree's leaves into ``model``'s parameters in place (their
    device and type), leaf for leaf; a shape that differs raises."""
    for path, shape, params, stacked in P.leaves(model):
        t = tensor_from_numpy(_leaf(tree, path))
        if tuple(t.shape) != shape:
            raise ValueError(f"{'.'.join(path)}: shape {tuple(t.shape)}, "
                             f"want {shape}")
        for i, p in enumerate(params):
            p.copy_(t[i] if stacked else t)


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device=None) -> P.ParamTree:
    """The JAX parameter tree → the family's model on ``device`` (the card
    unless named), leaf for leaf, in ``cfg``'s type."""
    model = api.empty_params(cfg, device)
    load_params_(cfg, model, tree)
    return model


@torch.no_grad()
def params_tree(cfg: ModelConfig, model: P.ParamTree) -> dict:
    """``model`` → the JAX package's tree of CPU tensors in the model's
    type, each stacked leaf stacked over its layers."""
    tree = {}
    for path, _, params, stacked in P.leaves(model):
        parts = [p.detach().cpu() for p in params]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack(parts) if stacked else parts[0]
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


def params_to_numpy(cfg: ModelConfig, model: P.ParamTree,
                    bfloat16=None) -> dict:
    """``model`` → the JAX package's numpy tree: the same names, shapes,
    types and values as the tree ``params_from_numpy`` takes."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_to_numpy(node, bfloat16)
    return conv(params_tree(cfg, model))
