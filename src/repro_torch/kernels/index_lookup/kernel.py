"""Hopper kernels for the batched index lookup: bind and launch.

Three CUDA C++ sources, one kernel each (their head comments give the
design and the bound): ``src/repro_torch/csrc/step_lookup.cu``,
``band_lookup.cu`` and ``segmented_step_lookup.cu``, which runs both
levels of the two-level scheme in one launch.  Each is built and loaded
through the port's one build path,
:class:`repro_torch.kernels._cuda.CudaLibrary` (nvcc for ``sm_90a`` at
first use; a failed build raises), and counts its own launches.

A wrapper checks its tensors, writes both windows into one (2, Q) int32
buffer, launches on PyTorch's current stream, checks
``cudaGetLastError()`` and counts the launch.  Nothing here touches the
card or the compiler at import.
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
STEP = CudaLibrary("step_lookup", [_P, _I, _P, _P, _P, _I, _P, _P],
                   extra_flags=(f"-DMAX_P={MAX_P}",))
BAND = CudaLibrary("band_lookup", [_P, _I, _P, _P, _P, _P, _P, _I, _P, _P],
                   extra_flags=(f"-DMAX_P={MAX_P}",))
SEGMENTED = CudaLibrary("segmented_step_lookup",
                        [_P, _I, _P, _P, _P, _I, _P, _P],
                        extra_flags=(f"-DSEG={LANE}",))
LIBS = (STEP, BAND, SEGMENTED)


def _queries(queries: torch.Tensor, what: str):
    """→ (device, its index, Q, the (2, Q) int32 output buffer)."""
    if not queries.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {queries.device}")
    if queries.dtype != torch.int32 or queries.dim() != 1 \
            or not queries.is_contiguous():
        raise ValueError(f"queries must be a contiguous 1-D int32 tensor, "
                         f"got {queries.dtype} {tuple(queries.shape)}")
    dev = queries.device
    Q = queries.numel()
    return dev, queries.get_device(), Q, torch.empty(
        (2, Q), dtype=torch.int32, device=dev)


def _layer(what: str, index: int, cap: int | None, *named) -> int:
    """Check one layer's ``(name, tensor, dtype)`` triples: each a
    contiguous 1-D tensor of that dtype on the card ``index``, all of the
    first one's width P, with 1 ≤ P (≤ ``cap``) → P."""
    first = named[0][1]
    P = first.numel() if first.dim() == 1 else -1
    if P < 1 or (cap is not None and P > cap):
        most = "" if cap is None else f" and at most {cap}"
        raise ValueError(f"layer of shape {tuple(first.shape)} unsupported: "
                         f"need a 1-D layer of at least 1{most} entries")
    for name, t, dtype in named:
        if not (t.is_cuda and t.get_device() == index and t.dtype == dtype
                and t.dim() == 1 and t.numel() == P and t.is_contiguous()):
            raise ValueError(f"{what}: {name!r} must be a contiguous {dtype} "
                             f"tensor of shape ({P},) on cuda:{index}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return P


def step_lookup_cuda(queries, keys, pos_lo, pos_hi):
    """(Q,) int32 queries against one step layer of P ≤ MAX_P entries
    (keys, pos_lo, pos_hi (P,) int32) on one CUDA device → (lo, hi), the
    two rows of one (2, Q) int32 buffer."""
    dev, index, Q, out = _queries(queries, "step_lookup_cuda")
    P = _layer("step_lookup_cuda", index, MAX_P,
               ("keys", keys, torch.int32), ("pos_lo", pos_lo, torch.int32),
               ("pos_hi", pos_hi, torch.int32))
    if Q:
        STEP.launch(dev, queries.data_ptr(), Q, keys.data_ptr(),
                    pos_lo.data_ptr(), pos_hi.data_ptr(), P, out.data_ptr())
    return out.unbind(0)


def band_lookup_cuda(queries, keys, x1, y1, m, delta):
    """(Q,) int32 queries against one band layer of P ≤ MAX_P nodes (keys
    (P,) int32; x1, y1, m, delta (P,) float32) → (lo, hi) int32, the two
    rows of one (2, Q) buffer."""
    dev, index, Q, out = _queries(queries, "band_lookup_cuda")
    P = _layer("band_lookup_cuda", index, MAX_P,
               ("keys", keys, torch.int32), ("x1", x1, torch.float32),
               ("y1", y1, torch.float32), ("m", m, torch.float32),
               ("delta", delta, torch.float32))
    if Q:
        BAND.launch(dev, queries.data_ptr(), Q, keys.data_ptr(),
                    x1.data_ptr(), y1.data_ptr(), m.data_ptr(),
                    delta.data_ptr(), P, out.data_ptr())
    return out.unbind(0)


def segmented_step_lookup_cuda(queries, keys, pos_lo, pos_hi):
    """(Q,) int32 queries against one step layer of any width P (keys,
    pos_lo, pos_hi (P,) int32): both levels of the two-level scheme in one
    launch (the segment search over every ``LANE``-th key, then the
    segment) → (lo, hi) int32, the two rows of one (2, Q) buffer."""
    dev, index, Q, out = _queries(queries, "segmented_step_lookup_cuda")
    P = _layer("segmented_step_lookup_cuda", index, None,
               ("keys", keys, torch.int32), ("pos_lo", pos_lo, torch.int32),
               ("pos_hi", pos_hi, torch.int32))
    if Q:
        SEGMENTED.launch(dev, queries.data_ptr(), Q, keys.data_ptr(),
                         pos_lo.data_ptr(), pos_hi.data_ptr(), P,
                         out.data_ptr())
    return out.unbind(0)


def grid_cap(device=None) -> int:
    """The most grid entries (one per ``LANE`` keys) a block of the
    segmented kernel stages in shared memory on ``device`` (the current
    card unless named): a layer of more segments searches its grid in
    global memory, in the same kernel."""
    fn = ctypes.CDLL(str(SEGMENTED.build())).segmented_step_lookup_grid_cap
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        return fn()
