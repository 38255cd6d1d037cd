"""The retune daemon on PyTorch/CUDA: observe → drift → warm retune → hot
swap, all under live traffic that never stops.

The closing move of the autonomous serving loop.  A traffic thread
hammers pipelined batches through one :class:`repro_torch.serve.IndexService`
— through a fault-injecting backend, so every read also rides the
:class:`repro_torch.api.RetryPolicy` — while the daemon thread:

1. tunes generation 0 for the tier it *thinks* it deploys on
   (azure_ssd) and opens it on the tier it ACTUALLY runs on
   (azure_hdd, ``persist_stats=True``),
2. watches :func:`repro_torch.api.detect_drift` until the observed
   per-lookup cost convicts the design (``action == "retune"``),
3. warm-retunes for the observed :class:`repro_torch.core.CachedProfile`
   (the shared ``LayerCache`` makes the search incremental), saves the
   new generation to a fresh file,
4. calls :meth:`IndexService.swap` — one pointer move under the
   service lock.  Batches in flight finish on the old epoch's backend
   and cache; batches after the swap serve entirely from the new one.
   The traffic thread never sees an error and no batch ever mixes
   bytes of two generations (verified below against per-generation
   ground truth),
5. keeps observing: the fresh epoch's stats re-convict or acquit the
   new design, and every retired generation leaves its ServeStats
   snapshot (``<path>.stats.json``) behind — the offline observe trail
   ``detect_drift_from_file`` reads.

Every tune and retune ranks its candidate layers on the card, and the
engine descends each batch's resident prefix there where the prefix packs
into the kernel's int32 planes (these gmm keys do not: the float64 walk
serves them, as in the JAX package).

Run:  PYTHONPATH=src python examples/torch/retune_daemon.py [--device cpu]
(the card by default; with no card and no ``--device`` it raises).
"""
import argparse
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, "src")

from repro_torch.api import (Index, RetryPolicy, ServeSpec, TuneSpec,
                             detect_drift)
from repro_torch.core import KeyPositions
from repro_torch.core.serialize import read_meta_path
from repro_torch.data.datasets import sosd_like
from repro_torch.kernels._cuda import resolve_device
from repro_torch.serve import FaultInjectingBackend, FileBackend
from repro_torch.serve.index_service import demo_serving_design

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

workdir = tempfile.mkdtemp(prefix="airindex-daemon-")
gen_path = lambda g: os.path.join(workdir, f"index-gen{g}.air")  # noqa: E731

TUNED_FOR, DEPLOYED_ON = "azure_ssd", "azure_hdd"
RETRY = RetryPolicy(max_attempts=4, backoff_s=1e-5, max_backoff_s=1e-3)
SPEC = ServeSpec(cache_bytes=(64 << 10,), pipeline_depth=2, retry=RETRY)
MIN_QUERIES = 2048


def chaotic(path):
    """The deployment's storage is not polite: transient EIO and torn
    reads on data pages (gated past the meta region so a dense schedule
    cannot spend the whole parse budget inside the header).  Every fault
    clears within the RetryPolicy budget — recoverable by contract."""
    meta_end = min(lm.offset for lm in read_meta_path(path).layers)
    return FaultInjectingBackend(FileBackend(path), seed=7, page_bytes=1024,
                                 eio_rate=0.35, eio_attempts=2,
                                 short_rate=0.25, short_attempts=1,
                                 only_from_offset=meta_end)


print("== generation 0: costed for the tier we THINK we deploy on ==")
keys = sosd_like("gmm", 80_000)
D = KeyPositions.fixed_record(keys, 16)
# a 3-layer design (2 disk layers + resident root): plenty of real
# preads for the faults to bite and for the cache to matter
idx = Index.from_design(demo_serving_design(D),
                        spec=TuneSpec(page_bytes=1024,
                                      cache_bytes=(64 << 10,)),
                        profile=TUNED_FOR, device=device)
idx.save(gen_path(0))
print(f"gen0 ({TUNED_FOR}): {idx.design.describe()}")

rng = np.random.default_rng(3)
batches = [rng.choice(D.keys, 256) for _ in range(6)]


def ground_truth(path):
    """Per-generation expected results, read fault-free."""
    from repro_torch.serve import IndexService
    with IndexService(path, profile=None, spec=SPEC,
                      device=device) as clean:
        return [clean.lookup(b) for b in batches]


wants = {0: ground_truth(gen_path(0))}

print(f"== serving on {DEPLOYED_ON} (the tier it ACTUALLY runs on), "
      "faults injected ==")
svc = idx.serve(profile=DEPLOYED_ON, spec=SPEC, persist_stats=True,
                backend_factory=chaotic)

stop = threading.Event()
served, errors = [], []


def hammer():
    while not stop.is_set():
        try:
            outs = svc.lookup_batches(batches)
        except Exception as e:          # the contract says: never
            errors.append(repr(e))
            return
        served.extend(zip(range(len(batches)), outs))


traffic = threading.Thread(target=hammer, name="daemon-traffic")
traffic.start()

print("== the daemon loop: observe → drift → warm retune → swap ==")
gen = 0
# fault counters live on the per-epoch ServeStats; fold each retiring
# epoch's tally in before its swap (the snapshot persists the rest)
absorbed = {"io_retries": 0, "degraded_runs": 0, "corrupt_pages": 0}


def fold(s):
    for k in absorbed:
        absorbed[k] += getattr(s, k)


for tick in range(4):
    while svc.stats.queries < MIN_QUERIES and not errors:
        time.sleep(0.02)                # traffic accumulates evidence
    report = detect_drift(svc, min_queries=MIN_QUERIES)
    print(f"tick {tick} (gen{gen}): {report.describe()}")
    if report.action != "retune":
        if report.action == "none":
            print(f"gen{gen} acquitted on {DEPLOYED_ON}: daemon idles.")
            break
        continue                        # "observe": not enough evidence yet
    # warm retune FOR the observed deployment (tier + cache headroom);
    # the search runs beside live traffic — old generation keeps serving
    nxt = idx.retune(report.observed_profile, warm_start=True).build()
    gen += 1
    nxt.save(gen_path(gen))
    wants[gen] = ground_truth(gen_path(gen))
    print(f"  retuned gen{gen}: {nxt.result.design.describe()} "
          f"(reused {nxt.result.stats.layers_reused} layer builds, "
          f"built {nxt.result.stats.layers_built} fresh)")
    if nxt.result.design.describe() == idx.design.describe():
        print("  (same shape, re-costed: the fresh epoch's honest "
              "recorded cost is what acquits or re-convicts it)")
    fold(svc.stats)                     # the retiring epoch's fault tally
    svc.swap(gen_path(gen))             # one pointer move, traffic live
    idx = nxt
    print(f"  swapped in under live traffic (swaps={svc.stats.swaps}); "
          f"gen{gen - 1} stats persisted to its .stats.json")

stop.set()
traffic.join()
fold(svc.stats)
svc.close()

print("== the atomicity audit: every batch belongs to ONE generation ==")
by_gen = {g: 0 for g in wants}
shared = mixed = 0
for i, out in served:
    ms = [g for g, want in wants.items() if np.array_equal(out, want[i])]
    if not ms:
        mixed += 1              # bytes of two generations in one batch
    elif len(ms) == 1:
        by_gen[ms[0]] += 1
    else:
        shared += 1             # generations tuned to identical designs
print(f"batches served: {len(served)}  "
      f"per generation: { {f'gen{g}': n for g, n in by_gen.items()} }  "
      f"identical across gens: {shared}  "
      f"mixed-epoch: {mixed}  errors: {errors}")
assert mixed == 0 and not errors, "hot swap broke batch atomicity"

print("== what the retry policy absorbed along the way ==")
print(f"io_retries={absorbed['io_retries']} "
      f"degraded_runs={absorbed['degraded_runs']} "
      f"corrupt_pages={absorbed['corrupt_pages']} "
      f"(none of it visible in results)")
snaps = sorted(f for f in os.listdir(workdir) if f.endswith(".stats.json"))
print(f"observe trail for the offline daemon: {snaps}")
print("done.")
