"""Error-feedback int8 gradient compression for the cross-pod axis, over
``torch.distributed``.

Cross-pod data parallelism reduces gradients over the slowest link.
Quantizing that all-reduce to int8 cuts its traffic 4× from float32; the
quantization error is carried in an *error-feedback* buffer so the scheme
is unbiased over time (SGD with error feedback converges at the same rate;
Karimireddy et al. 2019).

``compressed_psum(grads, err, group)`` runs on every rank of ``group``:

    q, new_err = quantize(g + err)
    g̃ = dequantize(all_reduce_sum(q)) / n

The per-tensor scale is the max-abs, agreed by ``all_reduce(MAX)`` so all
ranks quantize on one grid; the int8 codes are summed as int32 (``gloo``
has no int8 all-reduce, and n codes of ±127 overflow int8).  The float32
operations and their order are the JAX package's (``x / scale * 127``,
rounded half to even) as XLA compiles them, so the results equal its
``shard_map`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import tree_map
from repro_torch.kernels._cuda import resolve_device
from repro_torch.models.prng import fma


#: float32 1/127.  Inside the JAX package's jitted ``shard_map`` XLA turns
#: the divisions by the constants 127 and n into multiplications by their
#: float32 reciprocals and fuses the residual's multiply and subtract into
#: one multiply-add, so :func:`compressed_psum` does the same; the eager
#: ``compress_decompress`` divides, as :func:`dequantize_int8` does
INV_127 = float(np.float32(1) / np.float32(127))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale * 127.0), -127, 127) \
        .to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: PyTorch on a card multiplies by the reciprocal of
    # a host scalar divisor instead of dividing
    return q.to(torch.float32) * (scale / _f32(127.0, scale))


#: elements of one chunk of the residual's fused multiply-add (its float64
#: temporaries take ~40 bytes an element)
RESIDUAL_CHUNK = 1 << 24


def _residual(g: torch.Tensor, qf: torch.Tensor,
              step: torch.Tensor) -> torch.Tensor:
    """``g − qf·step`` rounded once, a chunk of the flat leaf at a time."""
    out = torch.empty_like(g)
    o, gf, q = out.view(-1), g.reshape(-1), qf.reshape(-1)
    for a in range(0, o.numel(), RESIDUAL_CHUNK):
        qa = q[a:a + RESIDUAL_CHUNK]
        o[a:a + RESIDUAL_CHUNK] = fma(-qa, step.expand_as(qa),
                                      gf[a:a + RESIDUAL_CHUNK])
    return out


def _scale(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x.abs().max(), _f32(1e-12, x))


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """Single-tensor quantize→dequantize (for error modeling/tests)."""
    scale = _scale(x)
    return dequantize_int8(quantize_int8(x, scale), scale)


def compressed_psum(grads, err, group=None):
    """Int8 all-reduce with error feedback over ``group`` (the default
    group when None), called on every rank of it.

    grads/err: trees (dicts, lists) of float32 tensors of one structure,
    on the group's device (CPU under ``gloo``, the card under NCCL).
    Returns (reduced_grads_mean, new_err).
    """
    n = dist.get_world_size(group)
    # XLA multiplies by the float32 reciprocal of the rank count too
    inv_n = float(np.float32(1) / np.float32(n))
    pairs = []

    def one(g, e):
        g = g.to(torch.float32) + e
        # shared scale: the max over ranks, so quantization grids agree
        scale = _scale(g)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = quantize_int8(g, scale)
        step = scale * INV_127
        new_e = _residual(g, q.to(torch.float32), step)   # local residual
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        pairs.append((summed.to(torch.float32) * step * inv_n, new_e))
        return len(pairs) - 1

    at = tree_map(one, grads, err)
    return (tree_map(lambda i: pairs[i][0], at),
            tree_map(lambda i: pairs[i][1], at))


def init_error_state(grads_like, device=None):
    """Zero float32 buffers shaped as the leaves of ``grads_like``: a
    tensor's on its device, a spec's (any leaf with a ``.shape`` and no
    ``.device``) on ``device``, the card unless the caller names
    another."""
    return tree_map(lambda g: torch.zeros(
        g.shape, dtype=torch.float32,
        device=getattr(g, "device", None) or resolve_device(device)),
        grads_like)
