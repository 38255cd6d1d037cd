"""Packing and dispatch for the fused multi-layer descent.

``fused_descent_with_backend`` is what the serving engine calls per batch:
one op walks the queries through the whole resident prefix and returns the
(L, Q) per-layer windows.  ``backend="numpy"`` is the bit-exact float64
walk.  ``backend="cuda"`` runs :class:`FusedDescent` on its device: a CUDA
device launches the hand-written kernel (or raises), a CPU device runs the
plain PyTorch version.  The device paths compute in int32/float32: step
rows stay exact, band rows are widened by the f32 δ slack (ranges remain
valid under Eq. 1 but may be wider).  A prefix or batch that the packing
guards decline is served by the numpy walk, exactly as in the JAX package.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
from torch import nn

from .._cuda import resolve_device
from . import kernel, ref

MAX_VMEM_ENTRIES = kernel.MAX_P  # plane width cap, equal to the JAX package's
LANE = kernel.LANE
KEY_PAD = np.iinfo(np.int32).max
# device paths index with int32; KEY_PAD must stay strictly greater than
# every real key AND every query, hence the -1
_I32_LIM = 2**31 - 1
PLANES = ("kinds", "keys", "pos_lo", "pos_hi", "x1", "y1", "m", "delta")


def band_f32_slack(y1, m, x1) -> np.ndarray:
    """Worst-case f32 rounding of ``mid = y1 + m·(q − x1)``: a few ULP of
    |y1| plus key-quantization error |m|·ULP(x1)."""
    return (8.0 + np.abs(np.asarray(y1, dtype=np.float64)) * 4e-6
            + np.abs(np.asarray(m, dtype=np.float64))
            * np.abs(np.asarray(x1, dtype=np.float64)) * 4e-6)


def _pad_up(n: int, mult: int) -> int:
    return n + (-n) % mult


def pack_prefix(layers) -> dict | None:
    """Pack a top-down resident prefix (parsed layer dicts, the
    :class:`repro_torch.serve.IndexService` representation) into the
    kernel's (L, P) numpy planes.

    Returns None when the prefix is empty, any layer overflows int32, or
    the common padded width exceeds :data:`MAX_VMEM_ENTRIES` — callers then
    serve on the numpy walk.
    """
    L = len(layers)
    if L == 0:
        return None
    widths = [len(lay["keys"] if lay["kind"] == "step" else lay["x1"])
              for lay in layers]
    P = _pad_up(max(widths), LANE)
    if P > MAX_VMEM_ENTRIES:
        return None
    kinds = np.zeros(L, dtype=np.int32)
    keys = np.full((L, P), KEY_PAD, dtype=np.int32)
    pos_lo = np.zeros((L, P), dtype=np.int32)
    pos_hi = np.zeros((L, P), dtype=np.int32)
    x1 = np.zeros((L, P), dtype=np.float32)
    y1 = np.zeros((L, P), dtype=np.float32)
    m = np.zeros((L, P), dtype=np.float32)
    delta = np.zeros((L, P), dtype=np.float32)
    for l, lay in enumerate(layers):
        n = widths[l]
        if lay["kind"] == "step":
            if (int(lay["keys"].max(initial=0)) >= _I32_LIM
                    or int(lay["pos_hi"].max(initial=0)) >= _I32_LIM):
                return None
            keys[l, :n] = lay["keys"]
            pos_lo[l, :n] = lay["pos_lo"]
            pos_hi[l, :n] = lay["pos_hi"]
        else:
            if int(lay["x1"].max(initial=0)) >= _I32_LIM:
                return None
            kinds[l] = 1
            keys[l, :n] = lay["x1"]
            x1[l, :n] = lay["x1"].astype(np.float32)
            y1[l, :n] = np.asarray(lay["y1"], dtype=np.float32)
            m[l, :n] = np.asarray(lay["m"], dtype=np.float32)
            delta[l, :n] = (np.asarray(lay["delta"], dtype=np.float64)
                            + band_f32_slack(lay["y1"], lay["m"],
                                             lay["x1"])).astype(np.float32)
    return {"kinds": kinds, "keys": keys, "pos_lo": pos_lo, "pos_hi": pos_hi,
            "x1": x1, "y1": y1, "m": m, "delta": delta}


class FusedDescent(nn.Module):
    """The packed resident prefix on one device.

    Holds the planes of :func:`pack_prefix` as registered buffers;
    ``forward(queries)`` maps (Q,) int32 queries on the same device to the
    (L, Q) int32 windows ``(lo, hi)``.  On a CUDA device it launches the
    hand-written kernel; on the CPU it runs the plain PyTorch version.

    :meth:`descend` is the serving engine's per-batch call, from uint64
    host queries to float64 host windows.  On a card it is one call into
    the kernel's library (``kernel.fused_descent_serve``) over staging
    buffers kept for the module's life and grown to the largest batch
    seen: pinned host buffers for the int32 queries and the (2, L, Q)
    output, and their device twins.  A batch is one host-to-device copy,
    one launch and one device-to-host copy queued on the current stream,
    then one synchronisation of that stream: no device allocation a
    batch.  :attr:`staging_lock` serialises :meth:`descend` across
    threads (the engine's prefetch worker descends too), which share the
    buffers.
    """

    def __init__(self, planes: dict, device=None):
        super().__init__()
        device = resolve_device(device)
        for name in PLANES:
            self.register_buffer(
                name, torch.from_numpy(np.ascontiguousarray(planes[name]))
                .to(device))
        self.staging_lock = threading.Lock()
        self._staging = None

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def planes(self) -> dict:
        return {name: getattr(self, name) for name in PLANES}

    def forward(self, queries: torch.Tensor):
        if queries.device.type == "cuda":
            return kernel.fused_descent_cuda(queries, *self.planes().values())
        if queries.device.type == "cpu":
            return ref.fused_descent_torch(self.planes(), queries)
        raise ValueError(f"FusedDescent runs on CUDA or the CPU, "
                         f"not {queries.device}")

    def descend(self, q: np.ndarray):
        """(Q,) uint64 host queries → float64 (L, Q) host windows
        ``(lo, hi)``, or None when a query is not below 2^31 − 1 (the
        caller's numpy walk serves such a batch)."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if self.device.type != "cuda":
            if int(q.max(initial=0)) >= _I32_LIM:
                return None
            lo, hi = self(torch.from_numpy(q.astype(np.int32)))
            return (lo.numpy().astype(np.float64),
                    hi.numpy().astype(np.float64))
        windows = np.empty((2, int(self.keys.shape[0]), len(q)),
                           dtype=np.float64)
        with self.staging_lock:
            if not kernel.fused_descent_serve(
                    q, tuple(self.planes().values()), self.staging(len(q)),
                    windows):
                return None
        return windows[0], windows[1]

    def staging(self, n: int) -> dict:
        """The staging buffers, grown first if they hold fewer than ``n``
        queries (call with :attr:`staging_lock` held)."""
        if self._staging is None or self._staging["q_pinned"].numel() < n:
            L = int(self.keys.shape[0])
            self._staging = {
                "q_pinned": torch.empty(n, dtype=torch.int32,
                                        pin_memory=True),
                "out_pinned": torch.empty(2 * L * n, dtype=torch.int32,
                                          pin_memory=True),
                "q_dev": torch.empty(n, dtype=torch.int32,
                                     device=self.device),
                "out_dev": torch.empty(2 * L * n, dtype=torch.int32,
                                       device=self.device)}
        return self._staging


def fused_descent_with_backend(layers, queries, *, backend: str = "cuda",
                               module: FusedDescent | None = None,
                               device=None):
    """Walk ``queries`` through a resident prefix in one fused dispatch →
    ``(lo, hi, backend_used)``: float64 arrays of shape (L, Q), row ``l``
    = layer ``l``'s window per query (top-down; row L−1 feeds the disk
    walk), and ``"cuda"`` or ``"numpy"`` — the engine attributes
    ``device_batches`` from it.

    ``module`` lets long-lived callers reuse one :class:`FusedDescent`
    (and its staging buffers) across batches; otherwise the prefix is
    packed onto ``device`` (the card unless named).
    """
    q = np.atleast_1d(np.asarray(queries, dtype=np.uint64))
    if backend == "cuda":
        if module is None:
            packed = pack_prefix(layers)
            if packed is not None:
                module = FusedDescent(packed, device=device)
        if module is not None and len(q):
            got = module.descend(q)
            if got is not None:
                return got[0], got[1], "cuda"
    elif backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    lo, hi = ref.fused_descent_ref(layers, q)
    return lo, hi, "numpy"


def fused_descent(layers, queries, *, backend: str = "cuda", packed=None,
                  device=None):
    """Walk ``queries`` through a resident prefix in one fused dispatch →
    ``(lo, hi)`` float64 arrays of shape (L, Q), as
    :func:`fused_descent_with_backend` without the backend that served.

    ``packed`` lets long-lived callers reuse one :func:`pack_prefix`
    result across batches; it is moved onto ``device`` (the card unless
    named).  ``backend="numpy"`` is the bit-exact float64 walk.
    """
    module = None
    if backend == "cuda" and packed is not None:
        module = FusedDescent(packed, device=device)
    lo, hi, _ = fused_descent_with_backend(layers, queries, backend=backend,
                                           module=module, device=device)
    return lo, hi
