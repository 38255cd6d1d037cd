#!/usr/bin/env python3
"""How far rwkv6-7b's decode drifts from its own prefill with depth: the
full-width model (random weights from seed 0) cut to ``--layers``, one
2 x ``--tokens`` prompt through ``make_prefill_step`` and, token by token,
``make_decode_step``; prints the last logits' max error over max |logit|.
The two paths compute the same function (the chunked scan against its
recurrence), so in float32 the error is rounding; in bf16 it shows how the
random model amplifies bf16 rounding layer by layer.

    PYTHONPATH=src python3 probes/rwkv_decode_drift.py --layers 2 \\
        --dtype bfloat16 [--tokens 128] [--device cpu]

On the CPU at 2 layers a run takes about a minute (bf16) of 8 threads.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg = get_config("rwkv6-7b").scaled(n_layers=args.layers,
                                        dtype=args.dtype)
    params = api.init_params(cfg, 0, args.device)
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab, (2, args.tokens)).astype(np.int32)).to(params.device)
    want = make_prefill_step(cfg)(params, {"tokens": toks}).float()
    state = api.init_decode_state(cfg, params, 2, args.tokens)
    decode = make_decode_step(cfg)
    for t in range(args.tokens):
        got, state = decode(params, {"tokens": toks[:, t:t + 1]}, state, t)
    want, got = want[:, :cfg.vocab], got.float()[:, :cfg.vocab]
    err = float((got - want).abs().max() / want.abs().max())
    print(f"rwkv6-7b at {args.layers} layers, {args.dtype}, 2 x "
          f"{args.tokens} on {params.device}: decode vs prefill max |logit| "
          f"err {err:.4e} of max |logit| {float(want.abs().max()):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
