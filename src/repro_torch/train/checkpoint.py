"""Checkpointing with an AirIndex manifest: the port's
``repro.train.checkpoint``, writing the same files.

A checkpoint is one packed blob of raw leaf bytes plus an AirTune-built
index over ``slice_id → byte range`` tuned for the checkpoint storage
tier.  Restore-after-failure reads the manifest root (one small read) and
then exactly the byte ranges of the slices a host needs — on a 1000-node
cluster each host restores only its own shards, O(Σ T(Δ_slice)) instead of
O(T(whole checkpoint)).

Leaves are split into fixed-grain slices (default 4 MiB) so partial
restore granularity is independent of tensor size.  Every slice carries a
crc32 for integrity; a corrupted slice fails loudly at restore.

The tree is a nested dict whose leaves are numpy arrays or CPU tensors
(``repro_torch.models.convert.params_tree`` gives a model's).  Leaves are
taken in ``jax.tree_util``'s order (dict keys sorted) and named by their
keys joined with "/", so for the same tree the blob, the ``.air`` index
and the ``.json`` meta are byte-identical to the JAX package's: a bfloat16
leaf is written as its raw 2-byte words with ``"dtype": "bfloat16"``, and
the index is tuned by the same AirTune with numpy ranking.  Restore gives
CPU tensors (numpy has no bfloat16) and fills each leaf's buffer in place
of the JAX package's ``raw += chunk``, which copies a leaf once per slice.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

from repro_torch.core import (PROFILES, KeyPositions, SerializedIndex,
                              StorageProfile, airtune, write_index)

SLICE_BYTES = 4 << 20


def _leaf_paths(tree, prefix=()) -> list:
    """(name, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order for a tree of dicts: keys sorted, names joined with "/"."""
    if not isinstance(tree, dict):
        return [("/".join(prefix), tree)]
    out = []
    for key in sorted(tree):
        out += _leaf_paths(tree[key], (*prefix, str(key)))
    return out


def _unflatten(tree, leaves):
    if not isinstance(tree, dict):
        return next(leaves)
    return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}


def _leaf_bytes(leaf) -> tuple:
    """→ (C-contiguous uint8 view of the leaf's bytes, shape, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    else:
        arr = np.asarray(leaf)
        name = str(arr.dtype)
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return raw, list(arr.shape), name


def _leaf_from_bytes(buf: np.ndarray, dtype: str, shape: list):
    """A CPU tensor of ``dtype`` (the meta's name) over the bytes."""
    if dtype == "bfloat16":
        return torch.from_numpy(buf.view(np.int16).reshape(shape)) \
            .view(torch.bfloat16)
    return torch.from_numpy(buf.view(np.dtype(dtype)).reshape(shape))


def save_checkpoint(path: str, tree, *, profile: StorageProfile | str =
                    "object_store", step: int = 0) -> dict:
    """Write blob + AirIndex manifest; returns the meta dict."""
    os.makedirs(path, exist_ok=True)
    if isinstance(profile, str):
        profile = PROFILES[profile]
    blob_path = os.path.join(path, f"ckpt-{step}.blob")
    slices = []       # (key, offset, size, crc, leaf_idx, slice_idx)
    leaves = []
    off = 0
    with open(blob_path, "wb") as f:
        for li, (name, leaf) in enumerate(_leaf_paths(tree)):
            raw, shape, dtype = _leaf_bytes(leaf)
            leaves.append({"name": name, "shape": shape, "dtype": dtype})
            for si in range(0, max(len(raw), 1), SLICE_BYTES):
                chunk = raw[si:si + SLICE_BYTES]
                f.write(chunk)
                slices.append({"leaf": li, "name": name, "off": off,
                               "size": len(chunk),
                               "crc": zlib.crc32(chunk)})
                off += len(chunk)
    # AirIndex over slice_id → byte range
    keys = np.arange(len(slices), dtype=np.uint64)
    offs = np.asarray([s["off"] for s in slices] + [off], dtype=np.int64)
    D = KeyPositions.from_offsets(keys, offs)
    tune = airtune(D, profile, k=3, score_backend="numpy")
    write_index(os.path.join(path, f"ckpt-{step}.air"), tune.design)
    meta = {
        "step": step,
        "blob_bytes": off,
        "slices": slices,
        "leaves": leaves,
        "index_cost_us": tune.cost * 1e6,
        "index_design": tune.design.describe(),
    }
    with open(os.path.join(path, f"ckpt-{step}.json"), "w") as f:
        json.dump(meta, f)
    return meta


def restore_checkpoint(path: str, tree_like, *, step: int = 0,
                       leaf_filter=None) -> tuple:
    """Restore (a subset of) leaves via manifest-indexed partial reads.

    ``tree_like`` gives the tree's structure (its leaves are not read);
    ``leaf_filter(name) → bool`` selects which leaves this host needs
    (None = all).  Returns (tree of CPU tensors, None where filtered out;
    stats) where stats records bytes read — the partial-restore win is
    visible there.
    """
    with open(os.path.join(path, f"ckpt-{step}.json")) as f:
        meta = json.load(f)
    idx = SerializedIndex(os.path.join(path, f"ckpt-{step}.air"))
    # airlint: allow[pread-seam] -- offline restore path: single-process,
    # CRC-checked per slice below; no serving retry/chaos semantics apply
    blob_fd = os.open(os.path.join(path, f"ckpt-{step}.blob"), os.O_RDONLY)
    stats = {"bytes_read": idx.bytes_read, "reads": idx.reads,
             "slices_read": 0}
    try:
        leaves_meta = meta["leaves"]
        by_leaf: dict[int, list] = {}
        for sid, s in enumerate(meta["slices"]):
            by_leaf.setdefault(s["leaf"], []).append((sid, s))
        out = []
        for li, (name, _) in enumerate(_leaf_paths(tree_like)):
            lm = leaves_meta[li]
            assert lm["name"] == name, (lm["name"], name)
            if leaf_filter is not None and not leaf_filter(name):
                out.append(None)
                continue
            parts = by_leaf[li]
            buf = np.empty(sum(s["size"] for _, s in parts), np.uint8)
            at = 0
            for sid, s in parts:
                lo, hi = idx.lookup(sid)          # Alg. 1 on the manifest
                lo = max(min(lo, s["off"]), 0)
                hi = max(hi, s["off"] + s["size"])
                # airlint: allow[pread-seam] -- offline restore read; slice
                # integrity is the crc32 assert below
                window = os.pread(blob_fd, hi - lo, lo)
                chunk = memoryview(window)[s["off"] - lo:
                                           s["off"] - lo + s["size"]]
                assert zlib.crc32(chunk) == s["crc"], f"corrupt slice {sid}"
                stats["bytes_read"] += hi - lo
                stats["reads"] += 1
                stats["slices_read"] += 1
                buf[at:at + len(chunk)] = np.frombuffer(chunk, np.uint8)
                at += len(chunk)
            out.append(_leaf_from_bytes(buf, lm["dtype"], lm["shape"]))
        stats["bytes_read"] += idx.bytes_read
        return _unflatten(tree_like, iter(out)), stats
    finally:
        idx.close()
        os.close(blob_fd)
