"""Public wrappers for the batched index lookup — the in-memory Alg. 1.

``lookup_step_layer`` / ``lookup_band_layer`` look one layer up for a
batch of queries.  A layer of at most :data:`MAX_VMEM_ENTRIES` entries
takes the single-call kernel; a wider step layer takes the two-level
scheme (a search over the sampled grid of every ``LANE``-th key, then each
query's own segment), which the segmented kernel runs in one launch.  ``traverse_index``
chains the layers top-down.  Dispatch is by the tensors' device: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor runs the
plain PyTorch version, which is for tests.

Arrays are int32 keys and positions, band parameters float32; the
conversion from the numpy ``IndexDesign`` is
:func:`device_arrays_from_design`.
"""
from __future__ import annotations

import numpy as np
import torch

from .._cuda import resolve_device
from ..fused_descent import band_f32_slack
from . import kernel, ref

MAX_VMEM_ENTRIES = kernel.MAX_P  # the single-call cap, the JAX package's
LANE = kernel.LANE
_I32 = 2**31


def _pick(queries: torch.Tensor, cuda_fn, torch_fn):
    if queries.device.type == "cuda":
        return cuda_fn
    if queries.device.type == "cpu":
        return torch_fn
    raise ValueError(f"index lookup runs on CUDA or the CPU, "
                     f"not {queries.device}")


def lookup_step_layer(queries, piece_keys, piece_pos):
    """Batched step-layer lookup: queries (Q,) int32; piece_keys (P,)
    int32 sorted; piece_pos (P+1,) int32 → (lo, hi) int32 of shape (Q,)."""
    pos_lo, pos_hi = piece_pos[:-1], piece_pos[1:]
    P = int(piece_keys.shape[0])
    if P <= MAX_VMEM_ENTRIES:
        fn = _pick(queries, kernel.step_lookup_cuda, ref.step_lookup_torch)
        return fn(queries, piece_keys, pos_lo, pos_hi)
    # two-level: the sampled grid picks each query's segment, then only
    # that segment (clipped at P − 1) is searched; on the card one launch
    # does both levels
    fn = _pick(queries, kernel.segmented_step_lookup_cuda, two_level_torch)
    return fn(queries, piece_keys, pos_lo, pos_hi)


def two_level_torch(queries, piece_keys, pos_lo, pos_hi):
    """The plain version of the two-level scheme: level 1
    (:func:`segment_bases`), then level 2
    (:func:`ref.segmented_step_lookup_torch`)."""
    return ref.segmented_step_lookup_torch(
        queries, segment_bases(piece_keys, queries), piece_keys, pos_lo,
        pos_hi, seg=LANE)


def segment_bases(piece_keys, queries):
    """Level 1 of the two-level scheme: each query's ``LANE``-wide segment
    start (int32), from a search over every ``LANE``-th key."""
    grid = piece_keys[::LANE].contiguous()
    g = (torch.searchsorted(grid, queries, right=True) - 1).clamp_(min=0)
    return (g * LANE).to(torch.int32)


def lookup_band_layer(queries, node_keys, x1, y1, m, delta):
    """Batched band-layer lookup → (lo, hi) int32 of shape (Q,).  Band
    layers are tuned small: more than :data:`MAX_VMEM_ENTRIES` nodes
    raise, as the JAX package asserts."""
    P = int(node_keys.shape[0])
    if P > MAX_VMEM_ENTRIES:
        raise ValueError(f"band layers are tuned small; got {P} nodes > "
                         f"{MAX_VMEM_ENTRIES}")
    fn = _pick(queries, kernel.band_lookup_cuda, ref.band_lookup_torch)
    return fn(queries, node_keys, x1, y1, m, delta)


def device_arrays_from_design(design, device=None) -> list[dict]:
    """Convert a numpy ``IndexDesign`` into kernel-ready int32/float32
    tensors on ``device`` (the card unless named), bottom-up as
    ``design.layers``.  Keys and positions must fit int32 (raises
    otherwise, where the JAX package asserts); band δ is widened by the
    f32 slack of :func:`band_f32_slack`."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    layers = []
    for layer in design.layers:
        if layer.kind == "step":
            if not (layer.piece_keys.max() < _I32
                    and layer.piece_pos.max() < _I32):
                raise ValueError("step layer keys/positions overflow int32")
            layers.append(dict(kind="step",
                               piece_keys=t(layer.piece_keys, np.int32),
                               piece_pos=t(layer.piece_pos, np.int32)))
        else:
            if not layer.node_keys.max() < _I32:
                raise ValueError("band layer keys overflow int32")
            slack = band_f32_slack(layer.y1, layer.m, layer.x1)
            layers.append(dict(kind="band",
                               node_keys=t(layer.node_keys, np.int32),
                               x1=t(layer.x1, np.float32),
                               y1=t(layer.y1, np.float32),
                               m=t(layer.m, np.float32),
                               delta=t(layer.delta + slack, np.float32)))
    return layers


def traverse_index(layers: list[dict], queries):
    """Batched Alg. 1 over kernel-ready layers → the bottom layer's
    (lo, hi).  As in the JAX package, every layer searches all of its own
    entries (no window is fed from one layer to the next): one launch per
    layer, top-down."""
    lo = hi = None
    for layer in reversed(layers):
        if layer["kind"] == "step":
            lo, hi = lookup_step_layer(queries, layer["piece_keys"],
                                       layer["piece_pos"])
        else:
            lo, hi = lookup_band_layer(queries, layer["node_keys"],
                                       layer["x1"], layer["y1"], layer["m"],
                                       layer["delta"])
    return lo, hi
