"""Sharded fleet serving on PyTorch/CUDA: per-shard tuning + one global
cache budget.

1. partitions a gmm dataset into 4 key-range shards and tunes each shard's
   index *independently* (:meth:`repro_torch.fleet.Fleet.tune` — one Alg. 2
   search per shard over its own keys, sharing one ``LayerCache``),
2. saves the fleet (per-shard ``shard_NNNN.air`` files + a ``fleet.json``
   manifest) and serves a *skewed* stream through scatter-gather
   (:class:`repro_torch.fleet.FleetService`) — results are bit-identical to
   looking every key up in its own shard,
3. persists per-shard ServeStats, so the fleet now *knows* which shards
   are hot,
4. re-tunes jointly with :meth:`Fleet.retune_budgeted`: every shard gets
   a tentative steady-state-cached design, the global cache budget is
   water-filled over the tentative designs by marginal E[T(Δ)] gain ×
   observed traffic, and each shard's final design is re-tuned for the
   hit rate its share actually buys — hot shards keep fine cached
   designs, priced-out shards fall back to coarse raw-tier designs,
5. serves again under the plan and reads the per-shard cache shares and
   hit rates off ``svc.stats_summary()``.

Every shard's search ranks its candidate layers on the card, and each
shard's engine takes the card for its resident descent where its prefix
packs into the kernel's int32 planes.

Run:  PYTHONPATH=src python examples/torch/serve_fleet.py [--device cpu]
(the card by default; with no card and no ``--device`` it raises).
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, "src")

from repro_torch.api import ServeSpec, TuneSpec
from repro_torch.core import KeyPositions
from repro_torch.data.datasets import sosd_like
from repro_torch.fleet import Fleet, FleetSpec
from repro_torch.kernels._cuda import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

workdir = tempfile.mkdtemp(prefix="airindex-fleet-")
fleet_dir = os.path.join(workdir, "fleet")
tier = "azure_ssd"
N_SHARDS = 4
WEIGHTS = (0.85, 0.09, 0.04, 0.02)        # skew: shard 0 takes 85% of traffic

print("== tune + save a 4-shard fleet (one search per shard) ==")
keys = sosd_like("gmm", 160_000)
D = KeyPositions.fixed_record(keys, 1024)
spec = FleetSpec(
    n_shards=N_SHARDS,
    tune=TuneSpec(lam_low=2**8, lam_high=2**17, k=3, max_layers=6,
                  page_bytes=4096),
    serve=ServeSpec(persist_stats=True))
fleet = Fleet.tune(D, tier, spec, device=device).build().save(fleet_dir)
print(fleet.describe())

print("== serve a skewed stream (scatter-gather, stats persisted) ==")
rng = np.random.default_rng(0)
bounds = fleet.shard_map.slice_bounds(D.keys)


def skewed_batch(n=512):
    sid = rng.choice(N_SHARDS, size=n, p=WEIGHTS)
    lo = np.array([bounds[s][0] for s in sid])
    hi = np.array([bounds[s][1] for s in sid])
    return D.keys[lo + (rng.random(n) * (hi - lo)).astype(np.int64)]


batches = [skewed_batch() for _ in range(12)]
with fleet.serve() as svc:
    flat = np.concatenate(batches)
    got = svc.lookup(flat)
    # scatter-gather identity: each key's range matches its own shard
    for sid, pos in fleet.shard_map.sub_batches(flat):
        solo = fleet.shards[sid].lookup(flat[pos]) + fleet.bases[sid]
        assert np.array_equal(got[pos], solo)
    svc.lookup_batches(batches)
    s = svc.stats_summary()
    print(f"served {s['queries']} queries, identity ok; per-shard load: "
          f"{[p['queries'] for p in s['shards']]}")

print("== joint retune: per-shard designs x global cache budget ==")
budget = 384 << 10                         # deliberately < total working set
fleet2, plan = Fleet.open(fleet_dir, data=D, device=device).retune_budgeted(
    data=D, total_cache_bytes=budget)
fleet2.build().save(fleet_dir + "2")
print(f"budget {budget >> 10} KiB water-filled by traffic x marginal gain:")
for d in plan.demands:
    share = plan.for_shard(d.shard)
    print(f"  shard {d.shard}: traffic={d.traffic:8.0f}  "
          f"working_set={d.working_set:7d} B  -> {share:7d} B "
          f"({'full' if share >= d.working_set > 0 else 'partial' if share else 'priced out'})")
print(f"designs: {[i.design.describe() for i in fleet2.shards]}")

print("== serve under the plan (hot shards earn their cache) ==")
with fleet2.serve() as svc:
    svc.lookup_batches([skewed_batch() for _ in range(12)])
    s = svc.stats_summary()
    for p in s["shards"]:
        print(f"  shard {p['shard']}: cache={sum(p['cache_bytes']):7d} B  "
              f"hit_rate={p['hit_rate']:.3f}  queries={p['queries']}")
    print(f"fleet per-query modeled cost: {s['query_modeled_us']:.1f}us "
          f"(uncached walk would pay {s['walk_query_us']:.1f}us)")
print("done.")
