#!/usr/bin/env python3
"""The CPU training launcher's default run, batch by batch: the loss of
its first and last batches under the seed-0 initial parameters and again
after all steps but the last (where the launcher reads its last loss), so
that the launcher's closing assertion (the last step's loss below the
first step's, two different batches) can be read against what the steps
did to each batch.

    PYTHONPATH=src python3 probes/smoke_train_batches.py [--seed 0] [--steps 20]

Uses the launcher's data (2,048 synthetic samples of uniform tokens, a
store tuned for azure_ssd), its batch iterator (4 x 128 from seed 0), its
AdamW defaults and SMOKE qwen3-14b, all on the CPU; prints one line per
batch.  About 10 s.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.store import ShardedTokenStore, write_token_store
    from repro_torch.models import api
    from repro_torch.train import TrainConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import loss_fn

    cfg = get_config("qwen3-14b", smoke=True)
    with tempfile.TemporaryDirectory() as work:
        rng = np.random.default_rng(0)          # the launcher's own store
        write_token_store(work, [rng.integers(0, cfg.vocab,
                                              rng.integers(64, 512))
                                 .astype(np.int32) for _ in range(2048)])
        store = ShardedTokenStore(work, profile="azure_ssd")
        it = store.batch_iterator(4, 128, seed=0)
        batches = [{k: torch.from_numpy(b[k]) for k in ("tokens", "labels")}
                   for b in (next(it) for _ in range(args.steps))]
        store.close()

    tcfg = TrainConfig()
    params = api.init_params(cfg, args.seed, "cpu")
    params.requires_grad_(True)
    opt = adamw_init(dict(params.named_parameters()), tcfg.optimizer)
    step = make_train_step(cfg, tcfg)

    def losses():
        with torch.no_grad():
            return [float(loss_fn(cfg, params, batches[i], tcfg)[0])
                    for i in (0, args.steps - 1)]

    before = losses()
    for b in batches[:-1]:
        step(params, opt, b)
    after = losses()
    for i, b, a in zip((0, args.steps - 1), before, after):
        print(f"seed {args.seed}, batch {i}: loss {b:.6f} from the initial "
              f"parameters, {a:.6f} after {args.steps - 1} steps "
              f"({a - b:+.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
