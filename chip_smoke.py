#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0] [--draws 230000000]

Phases (none catches its own failure; any failure exits non-zero):

1. Card: name and power limit from ``nvidia-smi``.
2. Build: compile the fused descent kernel from ``src/repro_torch/csrc``.
3. Kernel against its plain version: random packed prefixes (L in 1/2/4,
   step-only and mixed, P in 128/640/1664/4096, Q in 1/255/256/4097/65536);
   the kernel must equal ``fused_descent_torch`` on the card bit for bit,
   step rows must equal the float64 walk and band rows must contain it.
4. The main path at a deployment's size: ~200 M unique int32-domain keys
   from the paper's §7.1 100-cluster Gaussian mixture, 16-byte records,
   a gstep(8, 4096) <- gband(1024) <- gstep(8, 4096) index written paged
   with CRCs, served by ``IndexService`` on the card (two resident layers,
   a 1 MiB + 8 MiB block cache, a two-deep prefetch pipeline) over a
   uniform and a Zipf(1.1) stream of 256 batches x 4096 keys.  Every range
   must contain its key's record, equal the numpy backend's ranges, and a
   2,000-key sample must equal ``SerializedIndex.lookup``.
5. Numbers: sizes, build/generation times, per-stream qps, lookup wall,
   descent seconds, roofline and hit rate, and the kernel's time per launch
   beside its plain version and its bytes bound.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "src/repro_torch/csrc/fused_descent.cu"
KERNEL_REPLACES = "src/repro/kernels/fused_descent/kernel.py:96"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
RECORD_BYTES = 16
N_BATCHES = 256
BATCH = 4096
ZIPF_A = 1.1


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------
def random_prefix(rng, L: int, P: int, mixed: bool) -> list:
    """A top-down prefix of parsed layer dicts (the engine's resident form)
    whose packed width is exactly P; every layer starts at key 1, so all
    queries in [1, 2^31-2) lie in its domain."""
    layers = []
    for l in range(L):
        n = int(rng.integers(max(P - 127, 1), P + 1))
        keys = np.unique(rng.integers(2, 2**31 - 2, 3 * n + 8))
        keys = np.sort(rng.choice(keys, n - 1, replace=False))
        keys = np.concatenate([[1], keys]).astype(np.uint64)
        if mixed and (l % 2 == 1 or L == 1):
            layers.append({
                "kind": "band", "x1": keys,
                "y1": np.sort(rng.integers(0, 2**27, n)).astype(np.float64),
                "m": rng.uniform(0.0, 0.5, n),
                "delta": rng.uniform(1.0, 600.0, n)})
        else:
            pos = np.sort(rng.integers(0, 2**30, n + 1))
            layers.append({"kind": "step", "keys": keys,
                           "pos_lo": pos[:-1].astype(np.int64),
                           "pos_hi": pos[1:].astype(np.int64)})
    return layers


def check_kernel(device, seed: int) -> float:
    """Every tested shape: kernel == plain version bit for bit; step rows
    == float64 walk; band rows contain it.  Returns the max |kernel −
    plain| seen (0 when the check passes)."""
    import torch

    from repro_torch.kernels.fused_descent import (FusedDescent,
                                                   fused_descent_ref,
                                                   fused_descent_torch,
                                                   pack_prefix)
    rng = np.random.default_rng(seed)
    n_cases = 0
    max_err = 0
    for L in (1, 2, 4):
        for mixed in (False, True):
            for P in (128, 640, 1664, 4096):
                layers = random_prefix(rng, L, P, mixed)
                planes = pack_prefix(layers)
                assert planes is not None and planes["keys"].shape == (L, P)
                mod = FusedDescent(planes, device=device)
                for Q in (1, 255, 256, 4097, 65536):
                    q = rng.integers(1, 2**31 - 2, Q).astype(np.uint64)
                    qt = torch.from_numpy(q.astype(np.int32)).to(device)
                    klo, khi = mod(qt)
                    plo, phi = fused_descent_torch(mod.planes(), qt)
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    err = max(int((klo - plo).abs().max()),
                              int((khi - phi).abs().max()))
                    max_err = max(max_err, err)
                    if not (torch.equal(klo, plo) and torch.equal(khi, phi)):
                        raise AssertionError(
                            f"kernel != plain at L={L} mixed={mixed} P={P} "
                            f"Q={Q}: max |diff| {err}")
                    rlo, rhi = fused_descent_ref(layers, q)
                    klo = klo.cpu().numpy().astype(np.float64)
                    khi = khi.cpu().numpy().astype(np.float64)
                    for r in range(L):
                        if planes["kinds"][r] == 0:
                            ok = (np.array_equal(klo[r], rlo[r])
                                  and np.array_equal(khi[r], rhi[r]))
                        else:
                            ok = (np.all(klo[r] <= rlo[r])
                                  and np.all(khi[r] >= rhi[r]))
                        if not ok:
                            raise AssertionError(
                                f"kernel row {r} ({'band' if planes['kinds'][r] else 'step'})"
                                f" disagrees with the float64 walk at L={L} "
                                f"mixed={mixed} P={P} Q={Q}")
                    n_cases += 1
    log(f"kernel check: {n_cases} shapes, kernel == plain bit for bit, "
        f"step rows == float64 walk, band rows contain it")
    return float(max_err)


# ---------------------------------------------------------------------------
# phase 4: the main path at a deployment's size
# ---------------------------------------------------------------------------
def make_keys(draws: int, seed: int) -> np.ndarray:
    """The paper's §7.1 100-cluster Gaussian mixture inside the int32 key
    domain the kernel admits: centres U[2^26, 2^31-2^27), sigma
    U[2^21, 2^24), draws kept in [1, 2^31-2), deduplicated → sorted uint64."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(2**26, 2**31 - 2**27, 100)
    sigmas = rng.uniform(2**21, 2**24, 100)
    counts = rng.multinomial(draws, np.full(100, 0.01))
    x = np.empty(draws, dtype=np.float64)
    s = 0
    for c, sd, k in zip(centres, sigmas, counts):
        x[s:s + k] = rng.normal(c, sd, k)
        s += k
    keys = x[(x >= 1.0) & (x < 2.0**31 - 2)].astype(np.int64)
    del x
    # sort + neighbour mask rather than np.unique: numpy 2.3 runs unique
    # through a hash table, orders of magnitude slower than a sort on
    # ~10^8 distinct keys
    keys.sort()
    first = np.empty(len(keys), dtype=bool)
    first[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=first[1:])
    return keys[first].astype(np.uint64)


def build_design(keys: np.ndarray):
    """gstep(p=8, λ=4096) <- gband(λ=1024) <- gstep(p=8, λ=4096), built
    bottom-up with the port's builders (the band falls back to λ=2048 if it
    comes out wider than one kernel plane)."""
    from repro_torch.core import (IndexDesign, KeyPositions, build_gband,
                                  build_gstep, outline)
    from repro_torch.kernels.fused_descent import MAX_VMEM_ENTRIES
    D = KeyPositions.fixed_record(keys, RECORD_BYTES)
    l1 = build_gstep(D, 8, 4096)
    o1 = outline(l1, D)
    l2 = build_gband(o1, 1024)
    if l2.n_nodes > MAX_VMEM_ENTRIES:
        log(f"band layer has {l2.n_nodes} nodes > {MAX_VMEM_ENTRIES}: "
            f"rebuilding it with λ=2048")
        l2 = build_gband(o1, 2048)
    l3 = build_gstep(outline(l2, o1), 8, 4096)
    return IndexDesign(layers=(l1, l2, l3), data=D)


def make_streams(n_keys: int, seed: int, n_batches: int, batch: int) -> dict:
    """Key-index streams: uniform over the stored keys (Eq. 6's query
    distribution) and Zipf(1.1) over key ranks, with ranks scattered over
    the key space by a multiplicative bijection."""
    rng = np.random.default_rng(seed + 1)
    total = n_batches * batch
    uniform = rng.integers(0, n_keys, total)
    ranks = (rng.zipf(ZIPF_A, total) - 1) % n_keys
    mult = 2654435761                       # prime; bijective mod n_keys
    while math.gcd(mult, n_keys) != 1:
        mult += 2
    zipf = (ranks.astype(np.int64) * mult) % n_keys
    return {"uniform": uniform, "zipf": zipf}


def serve_stream(path: str, keys: np.ndarray, idx: np.ndarray, spec,
                 device, n_batches: int) -> tuple:
    """One cold service over one stream → (ranges (n, 2), report, the
    ``FusedDescent`` module that served it or None).  The service is
    closed before returning."""
    from repro_torch.serve import IndexService
    batches = np.split(keys[idx], n_batches)
    svc = IndexService(path, spec=spec, device=device)
    try:
        t0 = time.perf_counter()
        out = svc.lookup_batches(batches)
        wall = time.perf_counter() - t0
        st = svc.stats
        walls = np.asarray([w for _, w in st.lookup_samples])
        assert len(walls) == n_batches, (len(walls), n_batches)
        report = {
            "lookups": int(st.queries), "batches": int(st.batches),
            "wall_seconds": wall, "qps": st.queries / wall,
            "lookup_wall_samples": len(walls),
            "lookup_wall_mean_s": float(walls.mean()),
            "lookup_wall_median_s": float(np.median(walls)),
            "lookup_wall_p95_s": float(np.quantile(walls, 0.95)),
            "lookup_wall_p99_s": float(np.quantile(walls, 0.99)),
            "descent_seconds_per_batch": st.descent_seconds / st.batches,
            "roofline": st.roofline(), "hit_rate": st.hit_rate,
            "device_batches": int(st.device_batches),
            "device_active": bool(svc.device_active),
            "preads": int(st.preads)}
        fused = svc._st.fused
    finally:
        svc.close()
    return np.concatenate(out), report, fused


def check_ranges(ranges: np.ndarray, idx: np.ndarray, name: str) -> None:
    assert ranges.shape == (len(idx), 2) and ranges.dtype == np.int64, \
        (ranges.shape, ranges.dtype)
    rec = RECORD_BYTES * idx.astype(np.int64)
    bad = ~((ranges[:, 0] <= rec) & (ranges[:, 1] >= rec + RECORD_BYTES))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"{name}: {int(bad.sum())} ranges miss their "
                             f"record, first at key index {int(idx[i])}: "
                             f"{ranges[i].tolist()}")


def time_launches(fn, n: int, reps: int) -> float:
    """Median over ``reps`` of CUDA-event time per call for ``n``
    back-to-back calls of ``fn`` → milliseconds per call."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        per.append(e0.elapsed_time(e1) / n)
    return float(np.median(per))


def device_ms_per_call(fn, n: int) -> float:
    """Device time of every kernel ``fn`` launches, per call, from the
    profiler's CUPTI trace over ``n`` calls → milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    assert us > 0, "the profiler saw no device time"
    return us / n / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, default=230_000_000,
                    help="mixture draws before dedupe (cut only to fit a "
                         "time limit; no less than 110M keeps >= 100M keys)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.api import ServeSpec
    from repro_torch.core import SerializedIndex, write_index
    from repro_torch.kernels.fused_descent import kernel as K
    from repro_torch.kernels.fused_descent import fused_descent_torch

    device = torch.device("cuda")
    card = card_info()
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = K.build()
    log(f"build: {time.perf_counter() - t0:.3f} s -> "
        f"{os.path.relpath(lib, HERE)}")
    for line in K.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. kernel against its plain version ---------------------------------
    max_err = check_kernel(device, args.seed)

    # -- 4. the main path ----------------------------------------------------
    if args.draws < 230_000_000:
        log(f"reduced: {args.draws} mixture draws instead of 230000000")
    t0 = time.perf_counter()
    keys = make_keys(args.draws, args.seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    design = build_design(keys)
    t_build = time.perf_counter() - t0
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(workdir, "index.air")
        meta = write_index(path, design, data_record=RECORD_BYTES,
                           page_bytes=4096)
        sizes = [lay.n_nodes if lay.kind == "band" else lay.n_pieces
                 for lay in design.layers]
        log(f"keys: {len(keys)} unique ({args.draws} draws) in "
            f"{t_gen:.1f} s; data extent {design.data.size_bytes} B")
        log(f"index: layer entries {sizes} (bottom-up), built in "
            f"{t_build:.1f} s; file {os.path.getsize(path)} B, bottom layer "
            f"{meta.layers[0].size} B")

        spec = ServeSpec(resident_layers=2, cache_bytes=(1 << 20, 8 << 20),
                         pipeline_depth=2)
        streams = make_streams(len(keys), args.seed, N_BATCHES, BATCH)
        K.reset_launches()                    # the main path starts here
        served, reports, fused = {}, {}, {}
        for name, idx in streams.items():
            served[name], reports[name], fused[name] = serve_stream(
                path, keys, idx, spec, None, N_BATCHES)
        launches = K.launches()               # ... and ends here
        batches = sum(r["batches"] for r in reports.values())
        for name, r in reports.items():
            assert r["device_active"], f"{name}: resident prefix not on the card"
            assert r["device_batches"] == r["batches"], (name, r)
        assert launches >= batches, (launches, batches)
        for name, idx in streams.items():
            log(f"stream {name}: " + json.dumps(reports[name]))

        for name, idx in streams.items():
            check_ranges(served[name], idx, name)
            ref_ranges, _, _ = serve_stream(
                path, keys, idx, spec.replace(backend="numpy"), None,
                N_BATCHES)
            if not np.array_equal(served[name], ref_ranges):
                raise AssertionError(f"{name}: cuda ranges != numpy ranges")
        sample = streams["uniform"][:2000]
        sidx = SerializedIndex(path)
        try:
            want = np.asarray([sidx.lookup(int(k)) for k in keys[sample]],
                              dtype=np.int64)
        finally:
            sidx.close()
        if not np.array_equal(served["uniform"][:2000], want):
            raise AssertionError("served ranges != SerializedIndex.lookup")
        log(f"main path: {batches} batches, {launches} kernel launches; "
            f"ranges contain every record, equal the numpy backend's, and "
            f"a 2000-key sample equals SerializedIndex.lookup")

        # -- 5. the kernel at the serving shape ------------------------------
        # the module that served the uniform stream, on every one of its
        # batches (the last is timed below)
        mod = fused["uniform"]
        L, P = mod.keys.shape
        kinds = mod.kinds.cpu().numpy()
        for b in range(N_BATCHES):
            qt = torch.from_numpy(keys[streams["uniform"][
                b * BATCH:(b + 1) * BATCH]].astype(np.int32)).to(device)
            klo, khi = mod(qt)
            plo, phi = fused_descent_torch(mod.planes(), qt)
            serve_err = max(int((klo - plo).abs().max()),
                            int((khi - phi).abs().max()))
            max_err = max(max_err, float(serve_err))
            assert serve_err == 0, \
                f"serving batch {b}: kernel != plain ({serve_err})"

        def kern():
            return mod(qt)

        def plain():
            return fused_descent_torch(mod.planes(), qt)

        ms, plain_ms = device_ms_per_call(kern, 200), \
            device_ms_per_call(plain, 200)
        call_ms, plain_call_ms = time_launches(kern, 200, 15), \
            time_launches(plain, 200, 15)
        Q = BATCH
        n_band = int(kinds.sum())
        n_step = L - n_band
        # each input read once, each output written once: a step row needs
        # keys, pos_lo, pos_hi; a band row keys, x1, y1, m, delta
        nbytes = (4 * Q + 4 * L + 4 * L * P + 8 * P * n_step
                  + 16 * P * n_band + 8 * L * Q)
        # the search's compares (ceil(log2(P+1)) per query and layer) and a
        # band row's five f32 ops, floor and ceil; the guide's table has no
        # int32 rate, so the compares are priced at the f32 peak, which can
        # only make the operations time smaller
        ops = Q * (L * math.ceil(math.log2(P + 1)) + 7 * n_band)
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        bound_ms = max(bytes_s, ops_s) * 1e3
        bound_by = "bytes" if bytes_s >= ops_s else "operations"
        log(f"kernel at serving shape (Q={Q}, L={L}, P={P}) on {card}: "
            f"device {ms * 1e3:.3f} us/launch (plain torch {plain_ms * 1e3:.3f}"
            f" us of device time per call); wrapper call back to back "
            f"{call_ms * 1e3:.3f} us (plain torch {plain_call_ms * 1e3:.3f} us)"
            f"; bound {bound_ms * 1e3:.4f} us by {bound_by} ({nbytes} B, "
            f"{ops} ops; {n_step} step + {n_band} band layers); {launches} "
            f"launches on the main path")
        print(json.dumps({"kernels": [{
            "name": "fused_descent", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}]}))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
