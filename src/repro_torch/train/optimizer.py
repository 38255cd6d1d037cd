"""AdamW over a parameter tree: the port's ``repro.train.optimizer``.

The tree is a dict of tensors keyed by name (``dict(model.named_parameters())``
for a model); moments live beside each parameter on its device, in a
configurable dtype (fp32 default).  The math is the JAX package's, in
float32 and in its order: clip by the global norm, moments, bias
correction, decoupled weight decay, the warmup-cosine schedule.

Where the JAX package returns new trees (and donates the old buffers),
:func:`adamw_update` updates parameters and moments in place, under
``torch.no_grad()``, a block of rows at a time: the update is elementwise,
so the result is the same, and its float32 temporaries stay at
:data:`UPDATE_ELEMENTS` elements instead of several copies of the largest
leaf (the 778 M-element embedding of qwen3-14b).  The step count lives on
the host, so the schedule and the bias corrections are float32 scalars
computed there, without reading the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.params import TensorSpec

UPDATE_ELEMENTS = 1 << 24      # elements of one leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000


def _moment_dtype(ocfg: AdamWConfig) -> torch.dtype:
    return getattr(torch, ocfg.moment_dtype)


def opt_state_specs(param_specs: dict, ocfg: AdamWConfig) -> dict:
    """TensorSpecs of the state for a flat dict of parameter specs."""
    dt = _moment_dtype(ocfg)
    mom = {k: TensorSpec(tuple(s.shape), dt) for k, s in param_specs.items()}
    return {"m": mom, "v": dict(mom), "step": TensorSpec((), torch.int32)}


def adamw_init(params: dict, ocfg: AdamWConfig) -> dict:
    """Zero moments beside each parameter; ``step`` is a host int (the
    JAX package's int32 scalar)."""
    dt = _moment_dtype(ocfg)
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": 0}


def _schedule(step: int, ocfg: AdamWConfig) -> np.float32:
    """The learning rate at ``step``, in float32 as the JAX package
    computes it (its python constants enter as float32)."""
    f = np.float32
    step = np.int32(step)
    warm = min(f(step) / f(max(ocfg.warmup_steps, 1)), f(1.0))
    prog = np.clip(f(step - np.int32(ocfg.warmup_steps))
                   / f(max(ocfg.total_steps - ocfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return f(ocfg.lr) * warm * (f(0.1) + f(0.9) * cos)


def _row_blocks(t: torch.Tensor):
    """Views of ``t`` over its leading dimension, each at most
    :data:`UPDATE_ELEMENTS` elements (a leaf of 0 or 1 dimensions is one
    block)."""
    if t.dim() < 2:
        yield t
        return
    rows = max(1, UPDATE_ELEMENTS // max(1, t[0].numel()))
    for r in range(0, t.shape[0], rows):
        yield t[r:r + rows]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt(Σ leaves Σ x²) in float32, on the leaves' device (no read
    back)."""
    total = None
    for leaf in tree.values():
        for blk in _row_blocks(leaf):
            s = blk.float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, ocfg: AdamWConfig):
    """→ (params, state, metrics), with ``params`` and the moments updated
    in place; ``metrics`` holds ``grad_norm`` (a device scalar) and ``lr``
    (a float).  ``grads`` has the keys of ``params``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(ocfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(step, ocfg)
    b1, b2 = ocfg.b1, ocfg.b2
    f = np.float32
    bc1 = float(f(1) - f(b1) ** f(step))
    bc2 = float(f(1) - f(b2) ** f(step))
    lr, eps, wd = float(lr), ocfg.eps, ocfg.weight_decay
    for name, p in params.items():
        blocks = zip(_row_blocks(p), _row_blocks(grads[name]),
                     _row_blocks(state["m"][name]),
                     _row_blocks(state["v"][name]))
        for pb, gb, mb, vb in blocks:
            g = gb.float() * scale
            m32 = b1 * mb.float() + (1 - b1) * g
            v32 = b2 * vb.float() + (1 - b2) * torch.square(g)
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = pb.float()
            delta = mhat / (torch.sqrt(vhat) + eps) + wd * p32
            pb.copy_(p32 - lr * delta)
            mb.copy_(m32)
            vb.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
