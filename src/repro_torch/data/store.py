"""ShardedTokenStore — the data-pipeline AirIndex integration, the port's
copy of the JAX package's ``repro.data.store``.

Training corpora are packed variable-length token records inside shard
files on slow storage.  Random-access sample fetch needs
``sample_id → byte range``; that mapping is a key-position collection, so
the store tunes a hierarchical index for it with AirTune against the
*profiled* storage tier and serves lookups with real partial reads
(Alg. 1 over the serialized index + one data pread).

This makes data loading O(T(root) + Σ T(Δ_l) + T(record)) per random
sample instead of O(T(shard)).  Deterministic index-based sampling also
gives exact replay after restarts (``repro_torch.train.fault_tolerance``).

The store is host code (numpy), as in the JAX package: AirTune ranks its
candidates in numpy (``score_backend="numpy"``, the JAX package's
default), so the design and the written ``sample.air`` are bit-identical
to the reference's, and batches come out as numpy int32 for the trainer
to move to its device.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core import (PROFILES, KeyPositions, SerializedIndex,
                              StorageProfile, airtune, profile_local_storage,
                              write_index)
from repro_torch.core.serialize import open_file_backend


def write_token_store(path: str, samples: list[np.ndarray]) -> dict:
    """Pack variable-length int32 token records; returns manifest dict."""
    os.makedirs(path, exist_ok=True)
    data_path = os.path.join(path, "shard0.tokens")
    offs = [0]
    with open(data_path, "wb") as f:
        for s in samples:
            b = np.asarray(s, dtype=np.int32).tobytes()
            f.write(b)
            offs.append(offs[-1] + len(b))
    manifest = {"n": len(samples), "offsets_tail": offs[-1]}
    np.save(os.path.join(path, "offsets.npy"), np.asarray(offs, np.int64))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


class ShardedTokenStore:
    """Random-access token store with an AirTune-built sample index."""

    def __init__(self, path: str, profile: StorageProfile | str = "measure",
                 k: int = 3, backend_factory=None):
        self.path = path
        offs = np.load(os.path.join(path, "offsets.npy"))
        self.n = len(offs) - 1
        keys = np.arange(self.n, dtype=np.uint64)
        self.D = KeyPositions.from_offsets(keys, offs)
        if profile == "measure":
            profile = profile_local_storage(
                os.path.join(path, ".profile_scratch"))
        elif isinstance(profile, str):
            profile = PROFILES[profile]
        self.profile = profile
        self.tune = airtune(self.D, profile, k=k, score_backend="numpy")
        idx_path = os.path.join(path, "sample.air")
        write_index(idx_path, self.tune.design)
        self.index = SerializedIndex(idx_path,
                                     backend_factory=backend_factory)
        factory = backend_factory or open_file_backend
        self._data_backend = factory(os.path.join(path, "shard0.tokens"))
        self.offs = offs

    def close(self):
        self.index.close()
        self._data_backend.close()

    def get(self, sample_id: int) -> np.ndarray:
        """Fetch one sample via index lookup + partial data read (Alg. 1)."""
        lo, hi = self.index.lookup(int(sample_id))
        raw = self._data_backend.pread(hi - lo, lo)
        # last-mile: exact record range from the fetched window
        rec_lo = int(self.offs[sample_id]) - lo
        rec_hi = int(self.offs[sample_id + 1]) - lo
        assert 0 <= rec_lo <= rec_hi <= len(raw), "index returned bad range"
        return np.frombuffer(raw[rec_lo:rec_hi], dtype=np.int32)

    def batch_iterator(self, batch: int, seq_len: int, seed: int = 0,
                       start_step: int = 0):
        """Deterministic packed batches; replayable from any step."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.n)
        cursor = 0
        step = 0
        buf = []
        while True:
            while sum(len(b) for b in buf) < batch * (seq_len + 1):
                buf.append(self.get(int(perm[cursor % self.n])))
                cursor += 1
            flat = np.concatenate(buf)
            need = batch * (seq_len + 1)
            tokens = flat[:need].reshape(batch, seq_len + 1)
            buf = [flat[need:]]
            if step >= start_step:
                yield {"tokens": tokens[:, :-1].astype(np.int32),
                       "labels": tokens[:, 1:].astype(np.int32)}
            step += 1
