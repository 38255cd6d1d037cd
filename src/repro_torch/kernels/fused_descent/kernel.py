"""Hopper kernel for the fused multi-layer descent: build, bind, launch.

The CUDA C++ source is ``src/repro_torch/csrc/fused_descent.cu`` (its head
comment gives the design and the bound).  It is built and loaded through
the port's one build path, :class:`repro_torch.kernels._cuda.CudaLibrary`
(nvcc for ``sm_90a`` at first use, ``build/repro_torch/<hash>/``; a failed
build raises).

:func:`fused_descent_cuda` launches on PyTorch's current stream, checks
``cudaGetLastError()`` and counts every successful launch
(:func:`launches`), so a run can show that its main path went through
the kernel.  Nothing here imports anything GPU-specific at module import.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._cuda import CudaLibrary

# The one place the plane geometry is decided: the packer (ops.py) pads to
# LANE and caps at MAX_P, and nvcc sizes the shared-memory plane from MAX_P.
MAX_P = 4096      # plane width cap (int32 keys), equal to the JAX package's
LANE = 128        # plane width multiple

_PLANE_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int]
LIB = CudaLibrary(
    "fused_descent",
    [ctypes.c_void_p, ctypes.c_int] + _PLANE_ARGS + [ctypes.c_void_p] * 2,
    extra_flags=(f"-DMAX_P={MAX_P}",),
    entries={"serve": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
             + _PLANE_ARGS + [ctypes.c_void_p] * 4})
#: what ``fused_descent_serve`` returns for a batch it declines
DECLINED = -1
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build


def _check_plane(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"fused_descent: plane {name!r} must be a contiguous "
                         f"{dtype} tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_descent_cuda(queries: torch.Tensor, kinds, keys, pos_lo, pos_hi,
                       x1, y1, m, delta):
    """Launch the kernel: queries (Q,) int32 on a CUDA device; planes as
    packed by ``ops.pack_prefix`` on the same device → (lo, hi) int32 of
    shape (L, Q), the two halves of one (2, L, Q) buffer.  Raises on
    anything the kernel does not take."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"fused_descent_cuda needs a CUDA tensor, got {dev}")
    if queries.dtype != torch.int32 or queries.dim() != 1 \
            or not queries.is_contiguous():
        raise ValueError(f"queries must be a contiguous 1-D int32 tensor, "
                         f"got {queries.dtype} {tuple(queries.shape)}")
    if keys.dim() != 2:
        raise ValueError(f"keys must be (L, P), got {tuple(keys.shape)}")
    L, P = (int(s) for s in keys.shape)
    if L < 1 or P < 1 or P % LANE or P > MAX_P:
        raise ValueError(f"plane shape (L={L}, P={P}) unsupported: need "
                         f"L >= 1 and P a multiple of {LANE} <= {MAX_P}")
    _check_plane("kinds", kinds, torch.int32, (L,), dev)
    for name, t in (("keys", keys), ("pos_lo", pos_lo), ("pos_hi", pos_hi)):
        _check_plane(name, t, torch.int32, (L, P), dev)
    for name, t in (("x1", x1), ("y1", y1), ("m", m), ("delta", delta)):
        _check_plane(name, t, torch.float32, (L, P), dev)
    Q = int(queries.shape[0])
    out = torch.empty((2, L, Q), dtype=torch.int32, device=dev)
    if Q > 0:
        LIB.launch(dev, queries.data_ptr(), Q, kinds.data_ptr(),
                   keys.data_ptr(), pos_lo.data_ptr(), pos_hi.data_ptr(),
                   x1.data_ptr(), y1.data_ptr(), m.data_ptr(),
                   delta.data_ptr(), L, P, out.data_ptr())
    return out[0], out[1]


def fused_descent_serve(q: np.ndarray, planes: tuple, staging: dict,
                        windows: np.ndarray) -> bool:
    """The serving engine's batch in one call of the source's
    ``fused_descent_serve``: the (Q,) contiguous uint64 host queries go
    through ``staging`` (``q_pinned``, ``out_pinned``: pinned int32 host
    tensors of at least Q and 2LQ; ``q_dev``, ``out_dev``: their device
    twins) and the packed ``planes`` (``ops.PLANES`` order, on the card)
    into ``windows``, a contiguous float64 (2, L, Q) array, with the
    stream synchronised.  → False, with nothing queued or counted, when a
    query is not below 2^31 − 1 (the batch belongs to the numpy walk).
    Raises on a CUDA error."""
    keys = planes[1]
    L, P = (int(s) for s in keys.shape)
    Q = len(q)
    if q.dtype != np.uint64 or not q.flags.c_contiguous \
            or windows.dtype != np.float64 or windows.shape != (2, L, Q) \
            or not windows.flags.c_contiguous:
        raise ValueError("fused_descent_serve needs contiguous uint64 "
                         "queries and a contiguous float64 (2, L, Q) array")
    if staging["q_pinned"].numel() < Q \
            or staging["out_pinned"].numel() < 2 * L * Q:
        raise ValueError("the staging buffers hold fewer than Q queries")
    return LIB.launch(
        keys.device, q.ctypes.data, Q, staging["q_pinned"].data_ptr(),
        staging["q_dev"].data_ptr(), *(t.data_ptr() for t in planes), L, P,
        staging["out_dev"].data_ptr(), staging["out_pinned"].data_ptr(),
        windows.ctypes.data, entry="serve", declined=DECLINED)
