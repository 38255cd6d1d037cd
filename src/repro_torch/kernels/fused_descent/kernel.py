"""Hopper kernel for the fused multi-layer descent: build, bind, launch.

The CUDA C++ source is ``src/repro_torch/csrc/fused_descent.cu`` (its head
comment gives the design and the bound).  It is compiled by hand with
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point,
loaded with ``ctypes``, at first use, into ``build/repro_torch/<hash>/`` of
the checkout — the hash covers the source and the flags, so an edited
source rebuilds.  A failed build raises; there is no fallback.

:func:`fused_descent_cuda` launches on PyTorch's current stream, checks
``cudaGetLastError()`` and counts every successful launch
(:func:`launches`), so a run can show that its main path went through
the kernel.  Nothing here imports anything GPU-specific at module import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

# The one place the plane geometry is decided: the packer (ops.py) pads to
# LANE and caps at MAX_P, and nvcc sizes the shared-memory plane from MAX_P.
MAX_P = 4096      # plane width cap (int32 keys), equal to the JAX package's
LANE = 128        # plane width multiple

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "fused_descent.cu"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DMAX_P={MAX_P}")

_build_mu = threading.Lock()
_lib = None
_lib_path = None
build_log = ""    # nvcc's output of the build this process ran ("" if cached)

_count_mu = threading.Lock()
_launches = 0


def launches() -> int:
    """Kernel launches since the last :func:`reset_launches`."""
    return _launches


def reset_launches() -> None:
    global _launches
    with _count_mu:
        _launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the fused descent kernel cannot be built")


def library_path() -> Path:
    """Where the build for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libfused_descent.so"


def build() -> Path:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, _lib_path, build_log
    if _lib is not None:          # every launch passes here: no file I/O
        return _lib_path
    with _build_mu:
        if _lib is not None:
            return _lib_path
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{build_log}")
            os.replace(tmp, out)        # atomic: no reader sees a torn .so
        lib = ctypes.CDLL(str(out))
        lib.fused_descent_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3)
        lib.fused_descent_launch.restype = ctypes.c_int
        lib.fused_descent_error_string.argtypes = [ctypes.c_int]
        lib.fused_descent_error_string.restype = ctypes.c_char_p
        _lib_path = out
        _lib = lib
        return out


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
    shape (L, Q).  Raises on anything the kernel does not take."""
    global _launches
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
    lo = torch.empty((L, Q), dtype=torch.int32, device=dev)
    hi = torch.empty((L, Q), dtype=torch.int32, device=dev)
    if Q == 0:
        return lo, hi
    build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib.fused_descent_launch(
            queries.data_ptr(), Q, kinds.data_ptr(), keys.data_ptr(),
            pos_lo.data_ptr(), pos_hi.data_ptr(), x1.data_ptr(),
            y1.data_ptr(), m.data_ptr(), delta.data_ptr(), L, P,
            lo.data_ptr(), hi.data_ptr(), stream)
    if err != 0:
        msg = _lib.fused_descent_error_string(err).decode()
        raise RuntimeError(f"fused_descent launch failed: CUDA error "
                           f"{err} ({msg})")
    with _count_mu:
        _launches += 1
    return lo, hi
