"""Hopper kernels for the batched index lookup: bind and launch.

Three CUDA C++ sources, one kernel each (their head comments give the
design and the bound): ``src/repro_torch/csrc/step_lookup.cu``,
``band_lookup.cu`` and ``segmented_step_lookup.cu``.  Each is built and
loaded through the port's one build path,
:class:`repro_torch.kernels._cuda.CudaLibrary` (nvcc for ``sm_90a`` at
first use; a failed build raises), and counts its own launches.

The wrappers launch on PyTorch's current stream, check
``cudaGetLastError()`` and count every successful launch.  Nothing here
touches the card or the compiler at import.
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaLibrary

# The layer width one block stages in shared memory: the JAX package's
# single-call (VMEM) cap, and nvcc sizes the shared array from it.
MAX_P = 4096
LANE = 128        # the segment width of the two-level path

_P, _I = ctypes.c_void_p, ctypes.c_int
STEP = CudaLibrary("step_lookup", [_P, _I, _P, _P, _P, _I, _P, _P, _P],
                   extra_flags=(f"-DMAX_P={MAX_P}",))
BAND = CudaLibrary("band_lookup",
                   [_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P],
                   extra_flags=(f"-DMAX_P={MAX_P}",))
SEGMENTED = CudaLibrary("segmented_step_lookup",
                        [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P],
                        extra_flags=(f"-DSEG={LANE}",))
LIBS = (STEP, BAND, SEGMENTED)


def _check(name: str, t: torch.Tensor, dtype, n: int, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"index_lookup: {name!r} must be a contiguous "
                         f"{dtype} tensor of shape ({n},) on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _queries(queries: torch.Tensor, what: str):
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {dev}")
    if queries.dtype != torch.int32 or queries.dim() != 1 \
            or not queries.is_contiguous():
        raise ValueError(f"queries must be a contiguous 1-D int32 tensor, "
                         f"got {queries.dtype} {tuple(queries.shape)}")
    Q = int(queries.shape[0])
    out = (torch.empty(Q, dtype=torch.int32, device=dev),
           torch.empty(Q, dtype=torch.int32, device=dev))
    return dev, Q, out


def _layer_width(keys: torch.Tensor, cap: int | None) -> int:
    if keys.dim() != 1 or keys.shape[0] < 1 \
            or (cap is not None and keys.shape[0] > cap):
        most = "" if cap is None else f" and at most {cap}"
        raise ValueError(f"layer of shape {tuple(keys.shape)} unsupported: "
                         f"need a 1-D layer of at least 1{most} entries")
    return int(keys.shape[0])


def step_lookup_cuda(queries, keys, pos_lo, pos_hi):
    """(Q,) int32 queries against one step layer of P ≤ MAX_P entries
    (keys, pos_lo, pos_hi (P,) int32) on one CUDA device → (lo, hi)."""
    dev, Q, (lo, hi) = _queries(queries, "step_lookup_cuda")
    P = _layer_width(keys, MAX_P)
    for name, t in (("keys", keys), ("pos_lo", pos_lo), ("pos_hi", pos_hi)):
        _check(name, t, torch.int32, P, dev)
    if Q:
        STEP.launch(dev, queries.data_ptr(), Q, keys.data_ptr(),
                    pos_lo.data_ptr(), pos_hi.data_ptr(), P, lo.data_ptr(),
                    hi.data_ptr())
    return lo, hi


def band_lookup_cuda(queries, keys, x1, y1, m, delta):
    """(Q,) int32 queries against one band layer of P ≤ MAX_P nodes (keys
    (P,) int32; x1, y1, m, delta (P,) float32) → (lo, hi) int32."""
    dev, Q, (lo, hi) = _queries(queries, "band_lookup_cuda")
    P = _layer_width(keys, MAX_P)
    _check("keys", keys, torch.int32, P, dev)
    for name, t in (("x1", x1), ("y1", y1), ("m", m), ("delta", delta)):
        _check(name, t, torch.float32, P, dev)
    if Q:
        BAND.launch(dev, queries.data_ptr(), Q, keys.data_ptr(),
                    x1.data_ptr(), y1.data_ptr(), m.data_ptr(),
                    delta.data_ptr(), P, lo.data_ptr(), hi.data_ptr())
    return lo, hi


def segmented_step_lookup_cuda(queries, seg_base, keys, pos_lo, pos_hi):
    """(Q,) int32 queries, each with its segment start ``seg_base`` (Q,)
    int32, against one step layer of any width P (keys, pos_lo, pos_hi
    (P,) int32) → (lo, hi) int32."""
    dev, Q, (lo, hi) = _queries(queries, "segmented_step_lookup_cuda")
    P = _layer_width(keys, None)
    _check("seg_base", seg_base, torch.int32, Q, dev)
    for name, t in (("keys", keys), ("pos_lo", pos_lo), ("pos_hi", pos_hi)):
        _check(name, t, torch.int32, P, dev)
    if Q:
        SEGMENTED.launch(dev, queries.data_ptr(), seg_base.data_ptr(), Q,
                         keys.data_ptr(), pos_lo.data_ptr(),
                         pos_hi.data_ptr(), P, lo.data_ptr(), hi.data_ptr())
    return lo, hi
