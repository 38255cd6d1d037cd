"""What every hand-written kernel of the port shares: the device an entry
point runs on, the backend names, the ``nvcc`` build, the ``ctypes``
binding and the launch count.

Each kernel's CUDA C++ source under ``src/repro_torch/csrc/`` exposes a
plain C entry point ``<name>_launch`` that returns ``cudaGetLastError()``
and ``<name>_error_string``.  :class:`CudaLibrary` compiles one source by
hand with ``nvcc`` for ``sm_90a`` into a shared library at first use, into
``build/repro_torch/<hash>/`` of the checkout — the hash covers the source
and the flags, so an edited source rebuilds — and loads it with
``ctypes.CDLL``: a call releases the GIL, so while the fused descent's
serving entry waits for the card the serving engine's other threads (its
numpy disk walk, its second descent) run on.  A failed build raises with
nvcc's log; there is no fallback.  Nothing here touches the card or the
compiler at import.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch"
#: backend names of the JAX package; "pallas" and "jnp" both name its
#: device path (fused descent, candidate scoring), which is the port's "cuda"
REFERENCE_BACKENDS = {"pallas": "cuda", "jnp": "cuda"}
#: flags every kernel library is compiled with; a kernel adds its own
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  With no card and no device named, this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def nvcc() -> str:
    """The ``nvcc`` to build with: on PATH, else under CUDA_HOME /
    CUDA_PATH / /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's kernels cannot be built")


class CudaLibrary:
    """One kernel source: its build, its loaded library and its launch
    count.

    ``argtypes`` are the C entry point's ctypes argument types (pointers
    and the stream as ``c_void_p``, ints as ``c_int``, floats as
    ``c_float``); ``entries`` maps the suffix of each further entry point
    (``<name>_<suffix>``, each launching the kernel once) to its argument
    types.  :meth:`launch` calls an entry point on PyTorch's current
    stream of ``device``, raises on a CUDA error and counts the launch;
    nothing else counts.
    """

    def __init__(self, name: str, argtypes, extra_flags=(), entries=None):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.argtypes = list(argtypes)
        self.entries = {"launch": self.argtypes,
                        **{k: list(v) for k, v in (entries or {}).items()}}
        self.build_log = ""   # nvcc's output of the build this process ran
        self._mu = threading.Lock()
        self._lib = None
        self._fns = {}
        self._path = None
        self._launches = 0

    # -- the launch count --------------------------------------------------
    def launches(self) -> int:
        """Kernel launches since the last :meth:`reset_launches`."""
        return self._launches

    def reset_launches(self) -> None:
        with self._mu:
            self._launches = 0

    # -- build -------------------------------------------------------------
    def library_path(self) -> Path:
        """Where the build for the current source and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_ROOT / h.hexdigest()[:16] / f"lib{self.name}.so"

    def build(self) -> Path:
        """Compile (once per source hash) and load the library."""
        if self._lib is not None:       # every launch passes here: no I/O
            return self._path
        with self._mu:
            if self._lib is not None:
                return self._path
            out = self.library_path()
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
                cmd = [nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(cmd)}\n{self.build_log}")
                os.replace(tmp, out)    # atomic: no reader sees a torn .so
            lib = ctypes.CDLL(str(out))
            fns = {}
            for suffix, argtypes in self.entries.items():
                fn = fns[suffix] = getattr(lib, f"{self.name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fns = fns
            self._path = out
            self._lib = lib
            return out

    # -- launch ------------------------------------------------------------
    def launch(self, device: torch.device, *args, entry: str = "launch",
               declined: int | None = None) -> bool:
        """Build if needed, then call ``<name>_<entry>(*args, stream)`` on
        the current stream of ``device`` → True.  An entry point may
        decline its input without launching by returning ``declined``:
        then → False, and nothing is counted."""
        if self._lib is None:
            self.build()
        here = torch.cuda.current_device()
        if device.index is not None and device.index != here:
            with torch.cuda.device(device):     # launch in its context
                return self.launch(device, *args, entry=entry,
                                   declined=declined)
        # the raw handle of the current stream: no torch.cuda.Stream object
        # a launch
        stream = torch._C._cuda_getCurrentRawStream(here)
        err = self._fns[entry](*args, stream)
        if declined is not None and err == declined:
            return False
        if err != 0:
            msg = getattr(self._lib, f"{self.name}_error_string")(err)
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{err} ({msg.decode()})")
        with self._mu:
            self._launches += 1
        return True
