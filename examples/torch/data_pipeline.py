"""Data-pipeline example on PyTorch: AirIndex-backed random-access token
store, feeding batches to the device.

Builds a packed token store on the local filesystem, PROFILES the real
disk (T(Δ), §3.2), tunes the sample index with AirTune, and compares the
measured fetch path against a naive full-shard read.  The sample
index is tuned and read on the host (numpy, as in the JAX package); the
replayed batches are moved to the device a training step would read them
on.

Run:  PYTHONPATH=src python examples/torch/data_pipeline.py [--device cpu]
(the card by default; with no card and no ``--device`` it raises).
"""
import argparse
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, "src")

from repro_torch.data.store import ShardedTokenStore, write_token_store
from repro_torch.kernels._cuda import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

root = tempfile.mkdtemp(prefix="airindex-data-")
rng = np.random.default_rng(0)
print("== writing 4000 variable-length samples ==")
samples = [rng.integers(0, 50_000, int(rng.integers(100, 2000)))
           .astype(np.int32) for _ in range(4000)]
write_token_store(root, samples)
total = sum(len(s) * 4 for s in samples)
print(f"store: {total / 1e6:.1f} MB packed tokens")

print("== profiling local disk + tuning the sample index ==")
store = ShardedTokenStore(root, profile="measure")
print(f"index: {store.tune.design.describe()}")
print(f"modeled lookup: {store.tune.cost * 1e6:.1f}us "
      f"(vs full-shard read {store.profile(total) * 1e6:.1f}us)")

print("== random-access fetches (real preads) ==")
ids = rng.integers(0, len(samples), 500)
t0 = time.perf_counter()
for i in ids:
    got = store.get(int(i))
    assert np.array_equal(got, samples[int(i)])
dt = (time.perf_counter() - t0) / len(ids)
print(f"500 verified fetches, {dt * 1e6:.0f}us each, "
      f"{store.index.bytes_read / max(store.index.reads, 1):.0f}B/index-read")

print("== deterministic replay (fault-tolerance contract) ==")
a = next(store.batch_iterator(8, 256, seed=3, start_step=5))
b = None
it = store.batch_iterator(8, 256, seed=3)
for _ in range(6):
    b = next(it)
assert np.array_equal(a["tokens"], b["tokens"])
on_device = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
assert torch.equal(on_device["tokens"].cpu(), torch.from_numpy(b["tokens"]))
print(f"replay from step 5 matches sequential iteration: OK "
      f"(batch {tuple(on_device['tokens'].shape)} on {device})")
store.close()
