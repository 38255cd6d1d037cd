"""Serving an index under heavy traffic on PyTorch/CUDA: the facade +
batched-engine walkthrough.

1. wraps a 3-layer design over a gmm dataset in the
   :class:`repro_torch.api.Index` facade and saves it *paged* (fixed-size
   pages = the cache unit) with its :class:`repro_torch.api.TuneSpec`
   recorded in the file meta,
2. reopens the file and serves a skewed query stream through
   :meth:`Index.serve` — the spec's two-tier LRU cache config applies
   automatically, and each batch's resident prefix descends in one
   launch of the fused-descent kernel on the card,
3. shows what the engine saves: coalesced preads, bytes served from
   cache, warm-vs-cold modeled latency,
4. closes the loop with AirTune: the observed hit rate becomes a
   :class:`repro_torch.core.CachedProfile` and :meth:`Index.retune`
   re-tunes the index *for* the cache (paper Fig. 1: a hotter tier wants
   a shallower index) using the spec the file remembers,
5. pipelines batches through :class:`repro_torch.api.ServeSpec` — a
   worker thread prefetches batch *i+1*'s pages while the kernel
   descends batch *i*'s resident prefix — and reads the compute-vs-I/O
   roofline off ``svc.stats``,
6. closes it end to end: serving on a degraded tier persists ServeStats
   next to the file, :meth:`Index.observe` flags the drift, and a
   warm-started retune (shared ``LayerCache``) searches again for the
   observed profile at a fraction of the cold-search work.

Run:  PYTHONPATH=src python examples/torch/serve_index.py [--device cpu]
(the card by default; with no card and no ``--device`` it raises).
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, "src")

from repro_torch.api import Index, PROFILES, ServeSpec, TuneSpec
from repro_torch.core import KeyPositions, expected_latency
from repro_torch.data.datasets import sosd_like
from repro_torch.kernels._cuda import resolve_device
from repro_torch.serve.index_service import demo_serving_design

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

workdir = tempfile.mkdtemp(prefix="airindex-serve-")
path = os.path.join(workdir, "index.air")
tier = "azure_ssd"

print("== build + save (paged, spec recorded) ==")
keys = sosd_like("gmm", 200_000)
D = KeyPositions.fixed_record(keys, 16)
spec = TuneSpec(page_bytes=4096, cache_bytes=(64 << 10, 1 << 20))
idx = Index.from_design(demo_serving_design(D),   # 3 layers: 2 disk + root
                        spec=spec, profile=tier, device=device)
idx.save(path)
print(f"design: {idx.design.describe()}")
print(f"file: {os.path.getsize(path)} B in {spec.page_bytes} B pages; "
      f"layer offsets {[lm.offset for lm in idx.file_meta.layers]}")

print("== serve a skewed stream (hot keys repeat) ==")
rng = np.random.default_rng(0)
reopened = Index.open(path, device=device)       # remembers spec + profile
assert reopened.spec == spec
svc = reopened.serve()                   # cache tiers from the spec
hot = rng.choice(D.keys, 512)                      # the working set
for step in range(6):
    qs = np.concatenate([rng.choice(hot, 768), rng.choice(D.keys, 256)])
    ranges = svc.lookup(qs)
    s = svc.stats
    print(f"batch {step}: hit_rate={s.hit_rate:.3f} "
          f"preads={s.preads} bytes_fetched={s.bytes_fetched} "
          f"bytes_from_cache={s.bytes_from_cache}")
print(f"descents on {svc.device}: {svc.stats.device_batches} of "
      f"{svc.stats.batches} batches")

print("== what the cache buys (cold vs warm, modeled) ==")
cold = reopened.serve(cache_bytes=(1 << 20,))
base = cold.stats.modeled_seconds
cold.lookup(hot)
cold_s = cold.stats.modeled_seconds - base
warm_base = cold.stats.modeled_seconds
cold.lookup(hot)                                    # same batch, warm
warm_s = cold.stats.modeled_seconds - warm_base
print(f"cold batch: {cold_s * 1e6:.1f}us modeled   "
      f"warm batch: {warm_s * 1e6:.1f}us modeled   "
      f"({cold_s / max(warm_s, 1e-12):.0f}x)")
cold.close()

print("== pipelined batches (ServeSpec: prefetch overlaps descent) ==")
# a deliberately tiny cache so batches miss: the worker thread prefetches
# batch i+1's pages while the kernel descends batch i
pipe = reopened.serve(spec=ServeSpec(cache_bytes=(8 << 10,),
                                     pipeline_depth=2, prefetch_layers=2))
batches = [rng.choice(D.keys, 400) for _ in range(4)]
pipe.lookup_batches(batches)
roof = pipe.stats.roofline()
print(f"pipelined {pipe.stats.pipelined_batches} batches, "
      f"{pipe.stats.overlapped_preads} preads overlapped with descent; "
      f"roofline: {roof['bound']}-bound "
      f"(io_fraction={roof['io_fraction']:.2f})")
pipe.close()

print("== re-tune FOR the cache (CachedProfile via Index.retune) ==")
eff = svc.cached_profile()           # T(Δ) at the observed hit rate
# warm_start shares the Index's LayerCache across retunes: every layer
# built here is free for the drift retune below
retuned = idx.retune(eff, k=3, warm_start=True).build()
plain = idx.retune(PROFILES[tier], k=3, warm_start=True).build()
print(f"observed hit rate: {eff.hit_rate:.3f}")
print(f"tuned for raw {tier}:  {plain.describe()}")
print(f"tuned for cached {tier}: {retuned.describe()}")
print(f"(current 3-layer design under cached profile: "
      f"{expected_latency(idx.design, eff) * 1e6:.1f}us)")
svc.close()

print("== the observe→retune loop (drift → warm-started search) ==")
degraded = "azure_hdd"                       # the tier it ACTUALLY runs on
svc = idx.serve(profile=degraded, persist_stats=True)
for _ in range(6):
    svc.lookup(rng.choice(D.keys, 512))
report = idx.observe(svc, min_queries=1024)  # live DriftReport; after
#   close(), idx.observe_offline() reads the persisted snapshot instead
print(report.describe())
observed = svc.observed_profile(measured=False)
svc.close()                                  # snapshot → index.air.stats.json
if report.action == "retune":
    warm = idx.retune(observed, warm_start=True, k=3).build()
    print(f"warm retune for {degraded}: {warm.result.describe()}")
    print(f"  (reused {warm.stats.layers_reused} builds from the earlier "
          f"searches via the shared LayerCache, built "
          f"{warm.stats.layers_built} fresh)")
print("done.")
