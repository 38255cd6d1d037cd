#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone on one card, at a depth of your
choice: the token store, attention's gradient and the training run
through ``launch.train.run`` with a killed host and a restore, with the
flash kernel built first (the only kernel the phase runs).

    python3 probes/train_phase.py [--layers 14] [--seed 0]

Prints the card, the build's wall, the phase's lines (step walls,
tokens/s, model TFLOP/s, peak memory, checkpoint walls) and its wall.
Used to find the deepest qwen3-14b that trains on one card before the
whole script runs.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="qwen3-14b layers (default: chip_smoke's)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import kernel as AK
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device is available", file=sys.stderr)
        return 1
    card = cs.card_info()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    AK.build()
    print(f"flash build {time.perf_counter() - t0:.3f} s", flush=True)
    if args.layers is not None:
        cs.TRAIN_LAYERS = args.layers
    t0 = time.perf_counter()
    n = cs.train_phase(args, torch.device("cuda"), card)
    print(f"phase 14 wall {time.perf_counter() - t0:.3f} s, flash launches "
          f"{n}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
