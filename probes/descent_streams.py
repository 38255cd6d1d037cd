#!/usr/bin/env python3
"""The fused descent of the serving path on one card, for two trees in
turns: the port as committed here, and an earlier commit of the repo
unpacked into a directory of this checkout.

    git archive <commit> | tar -x -C build/parent
    python3 probes/descent_streams.py [--parent build/parent] [--rounds 3]
                                      [--json PATH]

Each run is a fresh process on one tree, in rounds whose order alternates
(parent, change; then change, parent; ...).  A run serves the uniform
stream of ``chip_smoke.py`` phase 6 (256 batches x 4096 keys over ~200 M
keys, the same index file for every run, built once under
``build/probes/``) through ``IndexService`` and the tree's own descent,
with each call of ``fused_descent_with_backend`` timed by a wrapper
around it (and, where the tree has one, each call of the library's
serving entry ``fused_descent_serve``): the stream's lookups/s, the
descent's wall a batch and a call.  Then the same batches alone through
the same module, timed the same way; then the kernel's device time at
the serving shape (queued CUDA events, L2-cold and back to back, by this
checkout's ``chip_smoke.queued_device_ms`` for both trees).

A tree whose ``FusedDescent`` has no ``descend`` (the parent) does its
steps inline in ``fused_descent_with_backend``, where no wrapper can
reach them: its step split (the uint64 check and int32 cast,
``from_numpy``, ``.to``, the launch, two ``.cpu``, two float64 casts)
comes from a copy of those steps in the same order, timed one by one,
in a second stream of the same batches and alone.  The kernels are
built before the streams.  Prints one line a run and writes every run's
numbers to ``--json`` as JSON.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX = os.path.join(HERE, "build", "probes", "serve_index.air")
OLD_STEPS = ("check_cast", "from_numpy", "to_device", "launch", "lo_cpu",
             "hi_cpu", "f64")


def timing(fn, rec: list):
    """``fn`` itself, called through a wrapper that appends the wall of
    each call to ``rec``."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            rec.append(time.perf_counter() - t0)
    return timed


def old_steps(rec: dict):
    """The parent's ``fused_descent_with_backend`` on a packed module, its
    steps in its order, each step's wall appended to ``rec``."""
    import numpy as np
    import torch

    def run(layers, queries, *, backend="cuda", module=None, device=None):
        pc = time.perf_counter
        t = [pc()]
        q = np.atleast_1d(np.asarray(queries, dtype=np.uint64))
        assert int(q.max(initial=0)) < 2**31 - 1
        qi = q.astype(np.int32)
        t.append(pc())
        qt = torch.from_numpy(qi)
        t.append(pc())
        qt = qt.to(module.device)
        t.append(pc())
        lo, hi = module(qt)
        t.append(pc())
        lc = lo.cpu()
        t.append(pc())
        hc = hi.cpu()
        t.append(pc())
        a, b = lc.numpy().astype(np.float64), hc.numpy().astype(np.float64)
        t.append(pc())
        for i, step in enumerate(OLD_STEPS):
            rec.setdefault(step, []).append(t[i + 1] - t[i])
        rec.setdefault("total", []).append(t[-1] - t[0])
        return a, b, "cuda"
    return run


def summary(rec: dict) -> dict:
    import numpy as np
    return {k: {"mean_us": float(np.mean(v)) * 1e6,
                "median_us": float(np.median(v)) * 1e6, "n": len(v)}
            for k, v in rec.items()}


def worker(root: str) -> dict:
    """One run on the tree at ``root`` → its numbers."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch.serve.index_service as IS
    from repro_torch.api import ServeSpec
    from repro_torch.kernels.fused_descent import FusedDescent
    from repro_torch.kernels.fused_descent import kernel as FK

    FK.LIB.build()
    keys = cs.make_keys(cs.DRAWS, 0)
    if not os.path.exists(INDEX):
        from repro_torch.core import write_index
        os.makedirs(os.path.dirname(INDEX), exist_ok=True)
        write_index(INDEX + ".tmp", cs.build_design(keys),
                    data_record=cs.RECORD_BYTES, page_bytes=4096)
        os.replace(INDEX + ".tmp", INDEX)
    staged = hasattr(FusedDescent, "descend")
    spec = ServeSpec(resident_layers=2, cache_bytes=(1 << 20, 8 << 20),
                     pipeline_depth=2)
    idx = cs.make_streams(len(keys), 0, cs.N_BATCHES, cs.BATCH)["uniform"]
    batches = np.split(keys[idx], cs.N_BATCHES)
    engine = IS.fused_descent_with_backend
    library_call = getattr(FK, "fused_descent_serve", None)

    def wrap(rec: dict) -> None:
        rec["descent"], rec["library_call"] = [], []
        IS.fused_descent_with_backend = timing(engine, rec["descent"])
        if library_call is not None:
            FK.fused_descent_serve = timing(library_call,
                                            rec["library_call"])

    def unwrap(rec: dict) -> None:
        IS.fused_descent_with_backend = engine
        if library_call is not None:
            FK.fused_descent_serve = library_call
        if not rec.get("library_call"):
            rec.pop("library_call", None)

    in_stream, alone = {}, {}
    wrap(in_stream)
    try:
        ranges, report, mod = cs.serve_stream(INDEX, keys, idx, spec, None,
                                              cs.N_BATCHES)
    finally:
        unwrap(in_stream)
    cs.check_ranges(ranges, idx, "uniform")
    assert report["device_batches"] == report["batches"], report
    for b in batches[:16]:
        engine(None, b, module=mod)
    wrap(alone)
    try:
        for b in batches:
            assert IS.fused_descent_with_backend(None, b,
                                                 module=mod)[2] == "cuda"
    finally:
        unwrap(alone)
    out = {"root": root, "staged": staged, "card": cs.card_info(),
           "qps": report["qps"],
           "descent_seconds_per_batch": report["descent_seconds_per_batch"],
           "lookup_wall_median_s": report["lookup_wall_median_s"],
           "io_fraction": report["roofline"]["io_fraction"],
           "in_stream": summary(in_stream), "alone": summary(alone),
           "L_P": list(mod.keys.shape)}
    if not staged:
        steps_stream, steps_alone = {}, {}
        IS.fused_descent_with_backend = old_steps(steps_stream)
        try:
            ranges, report, _ = cs.serve_stream(INDEX, keys, idx, spec, None,
                                                cs.N_BATCHES)
        finally:
            IS.fused_descent_with_backend = engine
        cs.check_ranges(ranges, idx, "uniform")
        run = old_steps(steps_alone)
        for b in batches:
            run(None, b, module=mod)
        out["steps_in_stream"] = summary(steps_stream)
        out["steps_alone"] = summary(steps_alone)
        out["steps_stream_qps"] = report["qps"]
    # both trees' kernels are timed by this checkout's timer
    spec_t = importlib.util.spec_from_file_location(
        "committed_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    timer = importlib.util.module_from_spec(spec_t)
    spec_t.loader.exec_module(timer)
    qt = torch.from_numpy(batches[-1].astype(np.int32)).to("cuda")
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    rewrite = timer.queued_device_ms(flush.neg_, 20)
    out["kernel"] = {
        "cold_us": (timer.queued_device_ms(lambda: mod(qt), 20,
                                           before=flush.neg_)
                    - rewrite) * 1e3,
        "warm_us": timer.queued_device_ms(lambda: mod(qt), 50) * 1e3}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="build/parent")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", help="write every run's numbers here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker)), flush=True)
        return 0
    order = []
    for i in range(args.rounds):
        order += [args.parent, "."] if i % 2 == 0 else [".", args.parent]
    runs = []
    for root in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", root],
                              cwd=HERE, capture_output=True, text=True,
                              timeout=1200)
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            return 1
        run = json.loads(lines[-1][len("RESULT "):])
        runs.append(run)
        print(json.dumps({k: run[k] for k in (
            "root", "qps", "descent_seconds_per_batch", "kernel",
            "in_stream", "alone")}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
