#!/usr/bin/env python3
"""The step, band and segmented-step lookup kernels on one card, for two
trees in turns: the port as committed here, and an earlier commit of the
repo unpacked into a directory of this checkout.

    git archive <commit> | tar -x -C build/parent
    python3 probes/lookup_kernels.py [--parent build/parent] [--rounds 3]
                                     [--kernels step,band,segmented]
                                     [--json PATH]
    python3 probes/lookup_kernels.py --sweep [--kernels ...] [--json PATH]

Each run is a fresh process on one tree, in rounds whose order alternates
(parent, change; then change, parent; ...).  The layers are those of
``chip_smoke.py`` phase 9, made once by this checkout and kept under
``build/probes/`` for every run: the gstep(8, 4096) <- gband(1024) <-
gstep(8, 4096) design over the tuning phase's ~20.8 M keys (its 171-node
band layer and its 81,298-entry bottom step layer, which takes the
two-level path; its 2-entry top step layer, the path's step layer), a
723-node band layer (the width of the loop generations' band, from
``chip_smoke.lookup_layer``) and step layers of 1,000 and 4,096 entries
(the widest a single call takes) from the same function.  The queries
are stored keys, uniform over the collection: a 4,096-key batch and a
2^20-key batch.  ``--kernels`` picks the kernels a run takes (all three
unless named).

For each layer and batch a run takes, with this checkout's timers for both
trees (``chip_smoke.cold_device_ms`` and ``device_ms_per_call``: CUPTI
device rows, L2-cold with a 128 MiB rewrite before each call, and back to
back):

* ``kernel``: the tree's kernel wrapper alone (for the parent's segmented
  kernel, with the segment starts computed beforehand, as its wrapper
  takes them);
* ``library`` (step layers): the yardstick, ``torch.searchsorted`` and a
  gather from a table of (pos_lo, pos_hi) rows, L2-cold;
* ``layer``: the tree's layer call (``lookup_band_layer`` /
  ``lookup_step_layer``), all the device work one call queues (for the
  parent's two-level path, its level-1 PyTorch ops and the kernel);
* ``wrapper_us`` / ``layer_call_us``: the wall a call of each takes back
  to back (CUDA events around 200 calls, ``chip_smoke.time_launches``);
* the launches one layer call counts, and the output held against this
  checkout's plain version bit for bit.

With ``--sweep``, one process on this tree instead: each kernel built
again from a copy of its source under ``build/probes/`` with other launch
geometries written into its ``#define`` lines (step ``WIDE_BLOCK``,
``WIDE_UP_TO``, ``DEEP_BLOCK``, ``DEEP_PER_SM``, ``DEEP_ITEMS``; band ``BLOCK_Q``,
``BLOCKS_PER_SM``, ``DEEP_ITEMS``; segmented ``WIDE_BLOCK``,
``WIDE_PER_SM``, ``DEEP_BLOCK``, ``DEEP_PER_SM``), each held to the plain
version on both batches and timed L2-cold and back to back at both
batches, beside the committed geometry.

Prints one line a run (or a variant) and writes every number to
``--json``.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = os.path.join(HERE, "build", "probes", "lookup_layers.npz")
BIG = 1 << 20
DEVICE = "cuda"
KINDS = ("step", "band", "segmented")
STEP_P = (1000, 4096)               # the random step layers beside the top


def committed_chip_smoke():
    """This checkout's ``chip_smoke`` module (timers, data), whatever tree
    the process imports the port from."""
    spec = importlib.util.spec_from_file_location(
        "committed_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_layers() -> None:
    """The phase-9 layers and query batches, written once to LAYERS."""
    import numpy as np
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    cs = committed_chip_smoke()
    from repro_torch.kernels import index_lookup as il
    keys = cs.make_keys(cs.TUNE_DRAWS, 3)
    design = cs.build_design(keys)
    bottom, band = (il.device_arrays_from_design(design, device="cpu")[i]
                    for i in (0, 1))
    top = il.device_arrays_from_design(design, device="cpu")[2]
    rng = np.random.default_rng(17)
    b723 = cs.lookup_layer(rng, 723, band=True)
    q = keys[rng.integers(0, len(keys), BIG)].astype(np.int32)
    srng = np.random.default_rng(19)
    steps = {P: cs.lookup_layer(srng, P, band=False) for P in STEP_P}
    os.makedirs(os.path.dirname(LAYERS), exist_ok=True)
    np.savez(LAYERS + ".tmp.npz",
             seg_keys=bottom["piece_keys"].numpy(),
             seg_pos=bottom["piece_pos"].numpy(),
             top_keys=top["piece_keys"].numpy(),
             top_pos=top["piece_pos"].numpy(),
             **{f"s{P}_keys": k for P, (k, _) in steps.items()},
             **{f"s{P}_pos": p for P, (_, p) in steps.items()},
             **{f"b171_{k}": band[k].numpy()
                for k in ("node_keys", "x1", "y1", "m", "delta")},
             **{f"b723_{k}": a for k, a in zip(
                 ("node_keys", "x1", "y1", "m", "delta"), b723)},
             queries=q)
    os.replace(LAYERS + ".tmp.npz", LAYERS)


def step_layers(z, on) -> dict:
    """The probe's step layers on the card → {P: (keys, pos_lo, pos_hi,
    the yardstick's gather table)}: the path's top layer, then STEP_P."""
    import torch
    out = {}
    for name in ("top", *(f"s{P}" for P in STEP_P)):
        k, pos = on(z[f"{name}_keys"]), on(z[f"{name}_pos"])
        plo, phi = pos[:-1], pos[1:]
        # entry r of searchsorted-right is piece max(r − 1, 0)
        pos2 = torch.stack([plo, phi], 1)
        out[len(k)] = (k, plo, phi, torch.cat([pos2[:1], pos2]).contiguous())
    return out


def worker(root: str, kinds=KINDS) -> dict:
    """One run on the tree at ``root`` → its numbers."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch

    from repro_torch.kernels import index_lookup as il
    from repro_torch.kernels.index_lookup import kernel as IK
    cs = committed_chip_smoke()
    # this checkout's plain versions are the yardstick of both trees
    ref_spec = importlib.util.spec_from_file_location(
        "committed_ref", os.path.join(HERE, "src", "repro_torch", "kernels",
                                      "index_lookup", "ref.py"))
    ref = importlib.util.module_from_spec(ref_spec)
    ref_spec.loader.exec_module(ref)

    for lib in IK.LIBS:
        lib.build()
    z = np.load(LAYERS)
    dev = torch.device("cuda")

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    seg_takes_bases = len(inspect.signature(
        IK.segmented_step_lookup_cuda).parameters) == 5
    out = {"root": root, "card": cs.card_info(),
           "segmented_takes_bases": seg_takes_bases, "cases": {}}
    sk, sp = on(z["seg_keys"]), on(z["seg_pos"])
    plo, phi = sp[:-1], sp[1:]
    bands = {P: [on(z[f"b{P}_{k}"]) for k in ("node_keys", "x1", "y1", "m",
                                              "delta")] for P in (171, 723)}
    steps = step_layers(z, on)
    for Q in (4096, BIG):
        qt = on(z["queries"][:Q])
        cases = {}
        for P, (k, lo_, hi_, table) in (steps.items() if "step" in kinds
                                        else ()):
            pos = torch.cat([lo_, hi_[-1:]])
            cases[f"step P={P}"] = (
                IK.STEP,
                lambda k=k, lo_=lo_, hi_=hi_, qt=qt: IK.step_lookup_cuda(
                    qt, k, lo_, hi_),
                lambda k=k, pos=pos, qt=qt: il.lookup_step_layer(qt, k, pos),
                ref.step_lookup_torch(qt, k, lo_, hi_),
                lambda k=k, table=table, qt=qt: table[torch.searchsorted(
                    k, qt, right=True)])
        for P, bt in (bands.items() if "band" in kinds else ()):
            cases[f"band P={P}"] = (
                IK.BAND, lambda bt=bt, qt=qt: IK.band_lookup_cuda(qt, *bt),
                lambda bt=bt, qt=qt: il.lookup_band_layer(qt, *bt),
                ref.band_lookup_torch(qt, *bt), None)
        if "segmented" in kinds:
            g = (torch.searchsorted(sk[::il.LANE].contiguous(), qt,
                                    right=True) - 1).clamp_(min=0)
            bases = (g * il.LANE).to(torch.int32)
            want = ref.segmented_step_lookup_torch(qt, bases, sk, plo, phi)
            if seg_takes_bases:
                def seg(qt=qt, bases=bases):
                    return IK.segmented_step_lookup_cuda(qt, bases, sk, plo,
                                                         phi)
            else:
                def seg(qt=qt):
                    return IK.segmented_step_lookup_cuda(qt, sk, plo, phi)
            cases[f"segmented P={len(z['seg_keys'])}"] = (
                IK.SEGMENTED, seg,
                lambda qt=qt: il.lookup_step_layer(qt, sk, sp), want, None)
        for name, (lib, kern, layer, want, library) in cases.items():
            for fn in (kern, layer):
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{root}: {name} Q={Q} != plain")
            n0 = lib.launches()
            layer()
            torch.cuda.synchronize()
            launched = lib.launches() - n0
            reps = 200 if Q == 4096 else 50
            cases[name] = {
                "kernel_cold_us": cs.cold_device_ms(kern, 50) * 1e3,
                "kernel_warm_us": cs.device_ms_per_call(kern, reps) * 1e3,
                "layer_cold_us": cs.cold_device_ms(layer, 50) * 1e3,
                "layer_warm_us": cs.device_ms_per_call(layer, reps) * 1e3,
                "wrapper_us": cs.time_launches(kern, 200, 15) * 1e3,
                "layer_call_us": cs.time_launches(layer, 200, 15) * 1e3,
                "launches_per_layer_call": launched}
            if library is not None:
                cases[name]["library_cold_us"] = cs.cold_device_ms(
                    library, 50) * 1e3
        out["cases"][f"Q={Q}"] = cases
    return out


STEP_VARIANTS = {
    "committed": {},
    "one query a thread at every batch": {"WIDE_UP_TO": 64},
    "serving form in blocks of 128": {"WIDE_BLOCK": 128},
    "serving form in blocks of 512": {"WIDE_BLOCK": 512, "WIDE_PER_SM": 2},
    "serving form in blocks of 1024": {"WIDE_BLOCK": 1024,
                                       "WIDE_PER_SM": 1},
    "persistent 1024 x 1": {"DEEP_BLOCK": 1024, "DEEP_PER_SM": 1},
    "persistent 256 x 4": {"DEEP_BLOCK": 256, "DEEP_PER_SM": 4},
    "2 queries a thread a pass": {"DEEP_ITEMS": 2},
    "8 queries a thread a pass": {"DEEP_ITEMS": 8},
}
BAND_VARIANTS = {
    "committed": {},
    "128 threads, 8 blocks an SM": {"BLOCK_Q": 128, "BLOCKS_PER_SM": 8},
    "1 query a thread a pass": {"DEEP_ITEMS": 1},
    "2 queries a thread a pass": {"DEEP_ITEMS": 2},
}
SEGMENTED_VARIANTS = {
    "committed": {},
    "latency form in blocks of 128": {"WIDE_BLOCK": 128, "WIDE_PER_SM": 2},
    "latency form in blocks of 32": {"WIDE_BLOCK": 32, "WIDE_PER_SM": 8},
    "throughput form always": {"WIDE_PER_SM": 0},
    "throughput form, 1 block an SM": {"DEEP_PER_SM": 1},
    "throughput form, 256 x 4": {"DEEP_BLOCK": 256, "DEEP_PER_SM": 4},
}


def sweep(kinds=KINDS) -> dict:
    """The launch-geometry variants of this tree's step, band and
    segmented kernels → {batch: {layer: {variant: (cold us, warm us)}}}."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    cs = committed_chip_smoke()
    from repro_torch.kernels import index_lookup as il
    from repro_torch.kernels._cuda import NVCC_FLAGS, CudaLibrary
    from repro_torch.kernels.index_lookup import kernel as IK

    def variant(lib, label, defines):
        """``lib`` built from a copy of its source under ``build/probes/``
        with the ``#define`` lines of ``defines`` set to their values."""
        text = lib.source.read_text()
        for name, value in defines.items():
            line = re.compile(rf"^#define {name} \S+$", re.M)
            assert len(line.findall(text)) == 1, name
            text = line.sub(f"#define {name} {value}", text)
        path = Path(HERE, "build", "probes", lib.name, label.replace(
            " ", "_").replace(",", ""), f"{lib.name}.cu")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        out = CudaLibrary(lib.name, lib.argtypes,
                          extra_flags=lib.flags[len(NVCC_FLAGS):])
        out.source = path
        return out
    committed = {"step": IK.STEP, "band": IK.BAND,
                 "segmented": IK.SEGMENTED}
    variants = {"step": STEP_VARIANTS, "band": BAND_VARIANTS,
                "segmented": SEGMENTED_VARIANTS}
    libs = {(kind, k): variant(committed[kind], k, d)
            for kind in kinds for k, d in variants[kind].items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    z = np.load(LAYERS)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    sk, sp = on(z["seg_keys"]), on(z["seg_pos"])
    bands = {P: [on(z[f"b{P}_{k}"]) for k in ("node_keys", "x1", "y1", "m",
                                              "delta")] for P in (171, 723)}
    steps = step_layers(z, on)
    out = {"card": cs.card_info()}
    try:
        for Q in (4096, BIG):
            qt = on(z["queries"][:Q])
            cases = {}
            for P, (k, lo_, hi_, _) in steps.items():
                cases[f"step P={P}"] = (
                    "step", lambda k=k, lo_=lo_, hi_=hi_:
                    IK.step_lookup_cuda(qt, k, lo_, hi_),
                    il.step_lookup_torch(qt, k, lo_, hi_))
            for P, bt in bands.items():
                cases[f"band P={P}"] = (
                    "band", lambda bt=bt: IK.band_lookup_cuda(qt, *bt),
                    il.band_lookup_torch(qt, *bt))
            cases[f"segmented P={len(z['seg_keys'])}"] = (
                "segmented",
                lambda: IK.segmented_step_lookup_cuda(qt, sk, sp[:-1],
                                                      sp[1:]),
                il.two_level_torch(qt, sk, sp[:-1], sp[1:]))
            for name, (kind, fn, want) in cases.items():
                if kind not in kinds:
                    continue
                for (k, label), lib in libs.items():
                    if k != kind:
                        continue
                    IK.STEP, IK.BAND, IK.SEGMENTED = (
                        lib if kind == x else committed[x]
                        for x in ("step", "band", "segmented"))
                    got = fn()
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{label}: {name} Q={Q} != "
                                             f"plain")
                    r = (cs.cold_device_ms(fn, 50) * 1e3,
                         cs.device_ms_per_call(fn, 200 if Q == 4096 else 50)
                         * 1e3)
                    out.setdefault(f"Q={Q}", {}).setdefault(name, {})[
                        label] = r
                    print(f"Q={Q} {name} {label}: {r[0]:.3f} us cold, "
                          f"{r[1]:.3f} us back to back", flush=True)
    finally:
        IK.STEP, IK.BAND, IK.SEGMENTED = (
            committed[x] for x in ("step", "band", "segmented"))
    return out


def has_layers() -> bool:
    """LAYERS exists and holds every array this probe reads."""
    import numpy as np
    if not os.path.exists(LAYERS):
        return False
    with np.load(LAYERS) as z:
        return all(f"s{P}_keys" in z.files for P in STEP_P) \
            and "top_keys" in z.files


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="build/parent")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help="the kernels to take, of " + ", ".join(KINDS))
    ap.add_argument("--json", help="write every run's numbers here")
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's launch-geometry variants")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kinds = tuple(args.kernels.split(","))
    if not set(kinds) <= set(KINDS):
        ap.error(f"--kernels takes {', '.join(KINDS)}")
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker, kinds)), flush=True)
        return 0
    if not has_layers():
        make_layers()
    if args.sweep:
        out = sweep(kinds)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    order = []
    for i in range(args.rounds):
        order += [args.parent, "."] if i % 2 == 0 else [".", args.parent]
    runs = []
    for root in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", root, "--kernels", args.kernels],
                              cwd=HERE, capture_output=True, text=True,
                              timeout=900)
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            return 1
        run = json.loads(lines[-1][len("RESULT "):])
        runs.append(run)
        print(json.dumps(run), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
