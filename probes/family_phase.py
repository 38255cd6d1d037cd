#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone on one card: the MoE, VLM, hybrid,
RWKV and audio families served at their published widths through the two
attention kernels, with both kernels built first (the only kernels the
phase runs).

    python3 probes/family_phase.py [--seed 0] [--arch ARCH ...]

``--arch`` keeps only the named families of ``chip_smoke.FAMILIES``.
Prints the card, the builds' wall, the phase's lines (prefill tokens/s,
capacity drops, the scans' walls, the decode check, launches, peak
memory) and each family's wall.  Used to time the phase before the whole
script runs.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", action="append", default=None,
                    help="a family of chip_smoke.FAMILIES (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as AK
    if not torch.cuda.is_available():
        print("family_phase: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_info()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # one nvcc a source, together
        for fut in [pool.submit(lib.build) for lib in (AK.LIB, DK.LIB)]:
            fut.result()
    print(f"flash and decode builds {time.perf_counter() - t0:.3f} s",
          flush=True)
    if args.arch:
        known = dict(cs.FAMILIES)
        cs.FAMILIES = tuple((a, known[a]) for a in args.arch)
    t0 = time.perf_counter()
    n = cs.family_phase(args, torch.device("cuda"), card)
    print(f"phase 15 wall {time.perf_counter() - t0:.3f} s, launches {n}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
