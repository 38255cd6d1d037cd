"""Hopper kernel for decode attention: bind and launch.

The CUDA C++ source is ``src/repro_torch/csrc/decode_attention.cu`` (its
head comment gives the design and the bound).  It is built and loaded
through the port's one build path,
:class:`repro_torch.kernels._cuda.CudaLibrary` (nvcc for ``sm_90a`` at
first use; a failed build raises).

:func:`decode_attention_cuda` launches on PyTorch's current stream,
checks ``cudaGetLastError()`` and counts every successful launch
(:func:`launches`): one per call, whether or not the cache is split
across blocks (the split's combination runs inside the same launch).
Nothing here touches the card at import.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._cuda import CudaLibrary

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary(
    "decode_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
     _P, _P, _P, _P, _P, _P, _P])
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
TILE = 64                # keys per tile (TK in the source)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS: dict = {}


def split_count(rows: int, S: int, device: torch.device) -> int:
    """Blocks per row: enough for about four blocks per SM (a block with
    few warps hides little latency alone), each with at least one 64-key
    tile of the cache's capacity."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    want = -(-4 * _SMS[device] // rows)
    return max(1, min(want, -(-S // TILE)))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_length: torch.Tensor,
                          scale: float | None = None):
    """Launch the kernel: q (R, group, D), k/v (R, S, D), each contiguous
    float32 or bfloat16 on one CUDA device (k and v of one type),
    kv_length (R,) int32 there → (o (R, group, D), m (R, group),
    l (R, group)) float32; :func:`split_count` blocks share each row's
    live length.  Raises on anything the kernel does not take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs a CUDA tensor, "
                         f"got {dev}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"need q (R, group, D) and k, v (R, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    R, G, D = (int(n) for n in q.shape)
    S = int(k.shape[1])
    if k.shape[0] != R or k.shape[2] != D or R < 1 or S < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not pair")
    if D not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"head dim {D} (one of {HEAD_DIMS}) or group {G} "
                         f"(1..{MAX_GROUP}) unsupported")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"q, k, v must be float32 or bfloat16 (k and v "
                         f"alike), got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte "
                             f"aligned tensor on {dev}")
    if kv_length.device != dev or kv_length.dtype != torch.int32 \
            or tuple(kv_length.shape) != (R,) \
            or not kv_length.is_contiguous():
        raise ValueError(f"kv_length must be a contiguous ({R},) int32 "
                         f"tensor on {dev}")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    n_split = split_count(R, S, dev)
    o = torch.empty((R, G, D), dtype=torch.float32, device=dev)
    m = torch.empty((R, G), dtype=torch.float32, device=dev)
    l = torch.empty((R, G), dtype=torch.float32, device=dev)
    if n_split > 1:
        op = torch.empty((n_split, R, G, D), dtype=torch.float32, device=dev)
        mp = torch.empty((n_split, R, G), dtype=torch.float32, device=dev)
        lp = torch.empty((n_split, R, G), dtype=torch.float32, device=dev)
        parts = (op.data_ptr(), mp.data_ptr(), lp.data_ptr())
    else:
        parts = (o.data_ptr(), m.data_ptr(), l.data_ptr())   # unread
    LIB.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               kv_length.data_ptr(), R, G, S, D, n_split, scale,
               _DTYPES[q.dtype], _DTYPES[k.dtype], o.data_ptr(),
               m.data_ptr(), l.data_ptr(), *parts)
    return o, m, l
