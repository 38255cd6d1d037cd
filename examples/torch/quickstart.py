"""Quickstart on PyTorch/CUDA: tune an index for YOUR storage and data
(paper Alg. 2).

1. profiles the local filesystem (T(Δ), §3.2),
2. tunes an index for a gmm dataset through the ``repro_torch.api``
   facade (candidate layers ranked on the card),
3. compares the modeled latency against B-tree / RMI / PGM,
4. serializes the index (spec recorded on disk) and serves real
   partial-read lookups (Alg. 1) from the reopened file, then the same
   keys through the batched engine (its resident prefix, where the design
   keeps one above the root, descends on the card).

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
(the card by default; with no card and no ``--device`` it raises).
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, "src")

from repro_torch.api import Index, TuneSpec
from repro_torch.core import KeyPositions, expected_latency, profile_local_storage
from repro_torch.core.baselines import build_fixed_btree, tune_pgm, tune_rmi
from repro_torch.data.datasets import sosd_like
from repro_torch.kernels._cuda import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

workdir = tempfile.mkdtemp(prefix="airindex-")
print(f"== profiling local storage ({workdir}) ==")
prof = profile_local_storage(os.path.join(workdir, "scratch.bin"))
aff = prof.fit_affine()
print(f"measured T(4KB)={prof(4096) * 1e6:.1f}us  "
      f"affine fit: latency={aff.latency * 1e6:.1f}us "
      f"bandwidth={aff.bandwidth / 1e9:.2f}GB/s")

print("== dataset: gmm, 400k keys ==")
keys = sosd_like("gmm", 400_000)
D = KeyPositions.fixed_record(keys, 16)

print(f"== AirTune (Alg. 2) through the facade, ranked on {device} ==")
t0 = time.perf_counter()
idx = Index.tune(D, prof, TuneSpec(k=5), device=device).build()
print(f"tuned in {time.perf_counter() - t0:.2f}s -> {idx.describe()}")

for name, design in [
    ("B-TREE(255,4K)", build_fixed_btree(D)),
    ("RMI (tuned)", tune_rmi(D, prof).design),
    ("PGM (tuned)", tune_pgm(D, prof).design),
]:
    c = expected_latency(design, prof)
    print(f"  vs {name:16s}: {c * 1e6:9.1f}us  "
          f"({c / idx.cost:.2f}x slower than AirIndex)")

print("== serialized, real partial-read lookups ==")
idx_path = os.path.join(workdir, "index.air")
idx.save(idx_path)
rng = np.random.default_rng(0)
qs = rng.choice(keys, 1000)
with Index.open(idx_path, device=device) as reopened:   # no data needed
    assert reopened.spec == idx.spec         # the file remembers its spec
    t0 = time.perf_counter()
    ranges = reopened.lookup(qs)
    dt = (time.perf_counter() - t0) / len(qs)
    with reopened.serve() as svc:            # the batched engine
        assert np.array_equal(svc.lookup(qs), ranges)
        print(f"batched engine on {svc.device}: "
              f"{svc.stats.device_batches} prefix descent(s), ranges equal "
              f"the disk walk's")
print(f"1000 file lookups: {dt * 1e6:.1f}us each, "
      f"mean range {float(np.mean(ranges[:, 1] - ranges[:, 0])):.0f}B, "
      f"index file {os.path.getsize(idx_path)}B")
print("OK")
