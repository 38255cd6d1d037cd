#!/usr/bin/env python3
"""The candidate-scoring kernel on one card, against its settings and the
library: what the split-S design reaches and where its time goes.

    python3 probes/score_sweep.py [--json PATH]

Times, with CUDA events around calls queued behind a device sleep
(``chip_smoke.queued_numbers``: L2-cold, a 128 MiB rewrite before each
call, and back to back), on W ~ U[16, 1e6] and weights ~ U[0.5, 4] from
numpy seed 0 under azure_ssd's coefficients:

1. at the tuner's largest shape (C = 39, S = 65,654): copies of the
   committed source under ``build/probes/`` with BLOCK 256/512 x UNROLL
   4/8 written into their ``#define`` lines, each launched at 1/2/4/8
   blocks an SM for the split count (``split_count``'s rule, computed
   here), and a copy whose ticket is one ``atom.add.acq_rel`` in place of
   ``__threadfence`` + ``atomicAdd`` + ``__threadfence``, at the committed
   split count;
2. the committed kernel at C x S = 1 x 65,654, 39 x 65,654, 39 x 16,384,
   39 x 1,024 and 300 x 65,654, beside ``torch.addmv`` + ``div`` and a
   row sum (``W.sum(1)``), which read the same bytes.

A variant is launched here through its own library's C entry point,
with the committed wrapper's arguments; the port's modules are not
changed.  Every variant is held to the plain version at rtol 1e-5 first,
and runs twice in turns.  Prints each table as it is taken and writes all of
them to ``--json`` as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]

FENCED = """    __threadfence();                    // the partial is visible first
    if (atomicAdd(tickets + c, 1u) != (unsigned)(n_split - 1)) return;
    __threadfence();                    // ... then the others' partials"""
ACQ_REL = """    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(tickets + c) : "memory");
    if (prev != (unsigned)(n_split - 1)) return;"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the numbers here")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import PROFILES, affine_coefficients
    from repro_torch.kernels._cuda import CudaLibrary
    from repro_torch.kernels.candidate_score import affine_scores_torch
    from repro_torch.kernels.candidate_score import kernel as CK

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"card": cs.card_info()}
    ell, inv_bw = affine_coefficients(PROFILES["azure_ssd"])
    rng = np.random.default_rng(0)
    src = CK.LIB.source.read_text()
    for line in ("#define BLOCK 512 ", "#define UNROLL 4 ", FENCED):
        assert src.count(line) == 1, line
    work = Path(HERE, "build", "probes")
    work.mkdir(parents=True, exist_ok=True)

    def variant(name, text):
        path = work / name / "candidate_score.cu"
        path.parent.mkdir(exist_ok=True)
        path.write_text(text)
        lib = CudaLibrary("candidate_score", CK.LIB.argtypes)
        lib.source = path
        return lib

    libs = {f"block{b}_unroll{u}": (b, variant(
        f"block{b}_unroll{u}",
        src.replace("#define BLOCK 512 ", f"#define BLOCK {b} ")
        .replace("#define UNROLL 4 ", f"#define UNROLL {u} ")))
        for b in (256, 512) for u in (4, 8)}
    libs["acq_rel_ticket"] = (CK.BLOCK, variant(
        "acq_rel_ticket", src.replace(FENCED, ACQ_REL)))
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda v: v[1].build(), libs.values()))

    def n_split(C, S, bps, block):
        """``split_count``'s rule at ``bps`` blocks an SM and ``block``
        threads a block."""
        return max(1, min(-(-bps * sms // C), S // (4 * block)))

    def launch(lib, n, W, wt):
        """One launch of ``lib`` over ``n`` splits a row, with the
        committed wrapper's arguments → (C,) scores."""
        C, S = W.shape
        out = torch.empty(C, dtype=torch.float32, device=dev)
        part = torch.empty((C, n, 2), dtype=torch.float32, device=dev)
        lib.launch(dev, W.data_ptr(), wt.data_ptr(), C, S, float(ell),
                   float(inv_bw), n, part.data_ptr(), tickets.data_ptr(),
                   out.data_ptr())
        return out

    tickets = torch.zeros(1024, dtype=torch.int32, device=dev)

    def inputs(C, S):
        W = torch.from_numpy(rng.uniform(16, 1e6, (C, S))
                             .astype(np.float32)).to(dev)
        wt = torch.from_numpy(rng.uniform(0.5, 4, S)
                              .astype(np.float32)).to(dev)
        return W, wt

    W, wt = inputs(39, 65654)
    plain = affine_scores_torch(W, wt, ell, inv_bw)
    sweep = {}
    settings = [(name, block, lib, bps) for name, (block, lib) in libs.items()
                for bps in ((1, 2, 4, 8) if name.startswith("block")
                            else (CK.BLOCKS_PER_SM,))]
    for rep in range(2):
        for name, block, lib, bps in (settings if rep == 0
                                      else settings[::-1]):
            n = n_split(39, 65654, bps, block)
            got = launch(lib, n, W, wt)
            torch.testing.assert_close(got, plain, rtol=1e-5, atol=0)
            cold, warm = cs.queued_numbers(
                {"k": lambda: launch(lib, n, W, wt)}, 20)
            sweep.setdefault(f"{name}_bps{bps}", []).append(
                {"cold_us": cold["k"] * 1e3, "warm_us": warm["k"] * 1e3,
                 "n_split": n})
    out["sweep_C39_S65654"] = sweep
    print(json.dumps(sweep), flush=True)

    shapes = {}
    for C, S in ((1, 65654), (39, 65654), (39, 16384), (39, 1024),
                 (300, 65654)):
        W, wt = inputs(C, S)
        den = wt.sum()
        base = torch.full((C,), ell, dtype=torch.float32, device=dev) * den
        fns = {"kernel": lambda: CK.affine_scores_cuda(W, wt, ell, inv_bw),
               "addmv_div": lambda: torch.addmv(base, W, wt, alpha=inv_bw)
               .div_(den),
               "row_sum": lambda: W.sum(dim=1)}
        for rep in range(2):
            cold, warm = cs.queued_numbers(fns, 20)
            for k in fns:
                shapes.setdefault(f"C{C}_S{S}", {}).setdefault(k, []).append(
                    {"cold_us": cold[k] * 1e3, "warm_us": warm[k] * 1e3})
        shapes[f"C{C}_S{S}"]["n_split"] = CK.split_count(C, S, sms)
        print(f"C={C} S={S}", json.dumps(shapes[f"C{C}_S{S}"]), flush=True)
    out["shapes"] = shapes
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
