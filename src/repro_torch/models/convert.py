"""Carry the JAX package's parameter tree into the port's
:class:`~repro_torch.models.transformer.Transformer`.

The tree is ``{"embed", "unembed", "final_norm", "blocks": {...}}`` with
every leaf a numpy array and the blocks stacked on a leading layer axis,
as ``repro.models.transformer.init_params`` makes it (pass each leaf
through ``np.asarray``).  A bfloat16 leaf is an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` refuses; it is carried through its
``uint16`` bits, so every value arrives exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Transformer, block_shapes, top_shapes


def tensor_from_numpy(x) -> torch.Tensor:
    """A numpy array (float32, float16 or ml_dtypes bfloat16) → a CPU
    tensor with the same values and type."""
    x = np.array(x)                       # a writable, contiguous copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device=None) -> Transformer:
    """The JAX parameter tree (numpy leaves) → a Transformer on ``device``
    (the card unless named), leaf for leaf, in ``cfg``'s type."""
    model = Transformer(cfg, device)
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
    return model
