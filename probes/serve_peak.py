#!/usr/bin/env python3
"""Phase 11 of a ``chip_smoke.py`` tree alone on one card, and its peak
device memory: the LLM serving path (qwen3-14b at full width and depth)
of this checkout or of an earlier commit unpacked into a directory of it.

    git archive <commit> | tar -x -C build/parent
    python3 probes/serve_peak.py build/parent          # as its script ran it
    python3 probes/serve_peak.py . --no-grad           # as this one runs it

Builds the two attention kernels of the tree, runs its ``llm_phase``
(under ``torch.no_grad()`` with ``--no-grad``, as this checkout's script
runs the phase; without, as earlier scripts did) and prints
``torch.cuda.max_memory_allocated`` over the phase with its wall and the
card.  Run each tree in its own process.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", help="a directory holding chip_smoke.py and src/")
    ap.add_argument("--no-grad", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as AK
    if not torch.cuda.is_available():
        print("serve_peak: no CUDA device is available", file=sys.stderr)
        return 1
    AK.build()
    DK.build()
    dev = torch.device("cuda")
    card = cs.card_info()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.no_grad() if args.no_grad else contextlib.nullcontext():
        cs.llm_phase(args, dev, card, {"flash_attention": 0.0,
                                       "decode_attention": 0.0})
    print(f"PEAK {args.tree} {torch.cuda.max_memory_allocated(dev)} B, "
          f"phase 11 {time.perf_counter() - t0:.1f} s, {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
