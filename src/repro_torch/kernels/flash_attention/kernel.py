"""Hopper kernel for flash attention: bind and launch.

The CUDA C++ source is ``src/repro_torch/csrc/flash_attention.cu`` (its
head comment gives the design and the bound).  It is built and loaded
through the port's one build path,
:class:`repro_torch.kernels._cuda.CudaLibrary` (nvcc for ``sm_90a`` at
first use; a failed build raises).

:func:`flash_attention_cuda` launches on PyTorch's current stream, checks
``cudaGetLastError()`` and counts every successful launch
(:func:`launches`).  Nothing here touches the card at import.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._cuda import CudaLibrary
from .ref import check_lengths

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
LIB = CudaLibrary(
    "flash_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
     *([_L] * 12), _P, _P])
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the source's tiles: the wgmma kernel's query rows a block, keys a tile
# and ring stages; the CUDA-core kernel's query and key tiles
WG_BQ, WG_BK, WG_STAGES, FMA_TILE = 128, 96, 4, 64


def kernel_path(dtype: torch.dtype) -> str:
    """Which kernel of the source a storage type launches: "wgmma" (tensor
    cores fed by TMA, bf16: the model's path) or "fma" (CUDA cores,
    float32, which no tensor-core path holds to 2e-5)."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash attention takes float32 or bfloat16, not "
                         f"{dtype}")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel ``dtype`` takes
    (``WgLayout`` / ``FlashSmem`` in the source; the card tests hold the
    two against each other)."""
    if kernel_path(dtype) == "wgmma":
        bars = (1 + 2 * WG_STAGES) * 8
        return 1024 + (WG_BQ + 2 * WG_STAGES * WG_BK) * D * 2 + bars
    return (3 * D * FMA_TILE + FMA_TILE * FMA_TILE) * 4


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None,
                         q_offset: int | None = None,
                         kv_length: torch.Tensor | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) of one
    type (float32 or bfloat16) on one CUDA device, each with a contiguous
    last dimension (other strides are free) → (B, Hq, Sq, D) in q's type.
    Query i sits at ``q_offset + i`` (default ``Skv − Sq``: end-aligned,
    which needs 1 ≤ Sq ≤ Skv, or Sq > Skv ≥ 1 with neither ``causal`` nor
    a ``window``).  ``kv_length`` ((B,) contiguous int32 on q's device)
    limits batch row b's keys to ``[0, kv_length[b])``, and the kernel
    then reads only those.  A query with no live key gets 0.  ``out``
    (same shape and type, last dimension contiguous) receives the result
    if given.  :func:`kernel_path` names the kernel the type takes.
    Raises on anything the kernel does not take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs a CUDA tensor, "
                         f"got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = (int(n) for n in q.shape)
    _, Hkv, Skv, _ = (int(n) for n in k.shape)
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not pair")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (one of {HEAD_DIMS}) unsupported")
    check_lengths(Sq, Skv, causal, window, q_offset)
    offset = Skv - Sq if q_offset is None else int(q_offset)
    if abs(offset) >= 2**30:
        raise ValueError(f"q_offset {offset} out of range")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kv_length is not None and (
            kv_length.device != dev or kv_length.dtype != torch.int32
            or tuple(kv_length.shape) != (B,)
            or not kv_length.is_contiguous()):
        raise ValueError(f"kv_length must be a contiguous ({B},) int32 "
                         f"tensor on {dev}")
    if out is None:
        out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=dev)
    elif out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype}")
    item = q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.device != dev or x.stride(3) != 1 or x.data_ptr() % 16 \
                or any((s * item) % 16 for s in x.stride()[:3]):
            raise ValueError(f"{name} must lie on {dev} with a contiguous "
                             f"head dimension and 16-byte aligned rows")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    LIB.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), B, Hq, Sq, Skv, Hkv, D, offset,
               int(bool(causal)), int(window or 0), float(softcap or 0.0),
               scale, _DTYPES[q.dtype], *q.stride()[:3], *k.stride()[:3],
               *v.stride()[:3], *out.stride()[:3],
               None if kv_length is None else kv_length.data_ptr())
    return out
