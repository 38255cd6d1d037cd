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
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I,
     _P, _P, _P, _P, _P, _P, _P])
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build

HEAD_DIMS = (32, 64, 128)
TILE = 64                # keys per tile (TK / MMA_TK in the source)
ROW_TILE = 64            # query rows a block (TR in the source); a row
#                          with more takes a block per tile of them
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS: dict = {}
#: blocks of the tensor-core kernel an SM holds at D = 128 (two rings of
#: 96 KB); :func:`split_count` sizes one wave of them
BLOCKS_PER_SM = 2
# the source's constants: warps a block, keys a warp's slice, ring stages
MMA_WARPS, MMA_KEYS, MMA_STAGES = 4, 16, 3


def kernel_path(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """Which kernel of the source a (q, k/v) type pair launches: "mma"
    (tensor cores, bf16 x bf16: the model's path) or "fma" (CUDA cores,
    the other three pairs)."""
    for dt in (q_dtype, kv_dtype):
        if dt not in _DTYPES:
            raise ValueError(f"decode attention takes float32 or bfloat16, "
                             f"not {dt}")
    return "mma" if q_dtype == kv_dtype == torch.bfloat16 else "fma"


def row_tiles(group: int) -> int:
    """Blocks a row's ``group`` query rows take (the grid's third
    dimension)."""
    return -(-group // ROW_TILE)


def smem_bytes(D: int, q_dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel the pair takes
    (``MmaSmem`` / ``DecodeSmem`` in the source, the CUDA-core kernel's
    with one head slot per row of a tile; the card tests hold the two
    against each other)."""
    if kernel_path(q_dtype, kv_dtype) == "mma":
        ring = MMA_WARPS * MMA_STAGES * 2 * MMA_KEYS * D * 2
        merge = MMA_WARPS * (16 * D + 2 * 16) * 4
        return max(ring, merge)
    G = ROW_TILE
    return (G * D + TILE * (D + 4) + TILE * D + G * TILE + 4 * (G // 2)
            + 2 * G) * 4


def split_count(rows: int, S: int, sms: int) -> int:
    """Blocks per row tile: one wave of :data:`BLOCKS_PER_SM` blocks on
    each of ``sms`` SMs shared over ``rows`` row tiles (the rows times
    :func:`row_tiles`; each tile's live keys are cut into that many
    chunks), at least one, and no more than the 64-key
    tiles of ``S``, the most keys a row can have live (the cache's
    capacity, or the window where that is smaller).  A pure function: the
    wrapper cannot read the rows' lengths without a synchronisation."""
    want = max(1, BLOCKS_PER_SM * sms // rows)
    return min(want, max(1, -(-S // TILE)))


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_length: torch.Tensor,
                          scale: float | None = None, *,
                          window: int | None = None,
                          softcap: float | None = None):
    """Launch the kernel: q (R, group, D) with any group ≥ 1 (a row's
    query heads times its new tokens, folded as ``ops`` folds them), k/v
    (R, S, D), each contiguous float32 or bfloat16 on one CUDA device (k
    and v of one type), kv_length (R,) int32 there → (o (R, group, D),
    m (R, group), l (R, group)) float32; :func:`row_tiles` blocks of up
    to 64 rows take a row, :func:`split_count` blocks share each tile's
    live length (the last ``window`` keys of it, when given), and
    :func:`kernel_path` names the kernel the types take.  ``softcap``
    caps the scaled scores at ``softcap·tanh(s/softcap)``.  Raises on
    anything the kernel does not take."""
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
    if D not in HEAD_DIMS or G < 1:
        raise ValueError(f"head dim {D} (one of {HEAD_DIMS}) or group {G} "
                         f"(query rows a row, at least 1) unsupported")
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
    if window is not None and int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if softcap is not None and not float(softcap) > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    live = S if window is None else min(S, int(window))
    n_split = split_count(R * row_tiles(G), live, _sms(dev))
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
               -1 if window is None else int(window),
               0.0 if softcap is None else float(softcap),
               _DTYPES[q.dtype], _DTYPES[k.dtype], o.data_ptr(),
               m.data_ptr(), l.data_ptr(), *parts)
    return o, m, l
