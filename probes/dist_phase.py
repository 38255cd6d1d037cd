#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone on one card: the multi-device
slice (the sequence-sharded decode through the decode kernel, and a
1-rank NCCL group's ``flash_decode_sharded`` and ``compressed_psum``),
with the decode kernel built first (the only kernel the phase runs).

    python3 probes/dist_phase.py [--seed 0]

Prints the card, the build's wall, the phase's lines (errors against the
unsharded kernel and the plain version, one shard's kernel time and the
combine's, the compression's error bounds and wall, launches) and the
phase's wall.  Used to time the phase before the whole script runs.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as DK
    if not torch.cuda.is_available():
        print("dist_phase: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_info()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    DK.LIB.build()
    print(f"decode build {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    n, err = cs.dist_phase(args, torch.device("cuda"), card)
    torch.cuda.synchronize()
    print(f"phase 16 wall {time.perf_counter() - t0:.3f} s, decode launches "
          f"{n}, largest shard partial error {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
