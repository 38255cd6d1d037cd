"""Hopper kernel for batched affine candidate scoring: bind and launch.

The CUDA C++ source is ``src/repro_torch/csrc/candidate_score.cu`` (its
head comment gives the design and the bound).  It is built and loaded
through the port's one build path,
:class:`repro_torch.kernels._cuda.CudaLibrary` (nvcc for ``sm_90a`` at
first use; a failed build raises).

:func:`affine_scores_cuda` launches on PyTorch's current stream, checks
``cudaGetLastError()`` and counts every successful launch
(:func:`launches`).  Nothing here touches the card at import.
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaLibrary

LIB = CudaLibrary(
    "candidate_score",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

BLOCK = 512              # threads a block (BLOCK in the source)
#: blocks the split count plans on for each SM: about two waves
BLOCKS_PER_SM = 2
#: elements a split streams at least: one 16-byte load a thread
MIN_SPLIT_ELEMS = 4 * BLOCK
_SMS: dict = {}
#: per device, the int32 ticket counters (one a row) that every launch
#: leaves at 0; launches on one device share them, so they run on one
#: stream at a time (the tuner scores from one thread)
_TICKETS: dict = {}


def split_count(C: int, S: int, sms: int) -> int:
    """Blocks a row: about :data:`BLOCKS_PER_SM` blocks on each of ``sms``
    SMs over the ``C`` rows, at least one, and no more than leaves each
    split :data:`MIN_SPLIT_ELEMS` elements.  A pure function of the shape
    and the card (7 at C = 39, S = 65,654 on 132 SMs)."""
    want = -(-BLOCKS_PER_SM * sms // C)
    return max(1, min(want, S // MIN_SPLIT_ELEMS))


def row_spans(c: int, S: int, n_split: int) -> list:
    """The element spans ``[a, b)`` of row ``c`` that each split reads, as
    the source cuts it (a mirror for the tests): split 0 first reads the
    scalar head and tail, then each split its 16-byte vectors of the
    body.  → one list of spans a split."""
    A = (-c * S) % 4
    nv = (S - A) // 4 if S >= A else 0
    if A > 0:
        nv = min(nv, (S - 4) // 4 if S >= 4 else 0)
    per = -(-nv // n_split)
    head = min(A, S)
    spans = []
    for i in range(n_split):
        j0 = min(i * per, nv)
        j1 = min(j0 + per, nv)
        own = [(A + 4 * j0, A + 4 * j1)] if j1 > j0 else []
        if i == 0:
            own = [(0, head), (head + 4 * nv, S)] + own
        spans.append([(a, b) for a, b in own if b > a])
    return spans


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _tickets(device: torch.device, C: int) -> torch.Tensor:
    """The device's ticket counters, grown (zeroed) to at least C."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < C:
        t = torch.zeros(max(C, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def affine_scores_cuda(widths: torch.Tensor, weights: torch.Tensor,
                       ell: float, inv_bw: float) -> torch.Tensor:
    """Launch the kernel: widths (C, S) and weights (S,), contiguous,
    16-byte aligned float32 on one CUDA device → (C,) float32 scores on
    that device; :func:`split_count` blocks share each row.  Raises on
    anything the kernel does not take."""
    dev = widths.device
    if dev.type != "cuda":
        raise ValueError(f"affine_scores_cuda needs a CUDA tensor, got {dev}")
    if widths.dtype != torch.float32 or widths.dim() != 2 \
            or not widths.is_contiguous():
        raise ValueError(f"widths must be a contiguous (C, S) float32 "
                         f"tensor, got {widths.dtype} {tuple(widths.shape)}")
    C, S = (int(n) for n in widths.shape)
    if C < 1 or S < 1:
        raise ValueError(f"widths shape (C={C}, S={S}) unsupported: need "
                         f"C >= 1 and S >= 1")
    if weights.device != dev or weights.dtype != torch.float32 \
            or tuple(weights.shape) != (S,) or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous float32 tensor of "
                         f"shape ({S},) on {dev}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")
    if widths.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("widths and weights must start 16-byte aligned")
    n_split = split_count(C, S, _sms(dev))
    out = torch.empty(C, dtype=torch.float32, device=dev)
    part = torch.empty((C, n_split, 2), dtype=torch.float32, device=dev)
    LIB.launch(dev, widths.data_ptr(), weights.data_ptr(), C, S,
               float(ell), float(inv_bw), n_split, part.data_ptr(),
               _tickets(dev, C).data_ptr(), out.data_ptr())
    return out
