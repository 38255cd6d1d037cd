"""Training launcher of the port: deterministic replayable data, the
chunked-CE train step, periodic AirIndex-manifest checkpoints and the
``TrainingSupervisor`` restart loop, on the card unless told otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --steps 20 --batch 4 --seq 128 [--device cpu]

:func:`run` is the loop of the JAX package's ``repro.launch.train.main``
on one device, with its flags (plus ``--device``) and its quirks: a
synthetic store of 2,048 samples is written when ``--data`` names none,
the samples index is tuned for ``azure_ssd``, parameters come from seed
0, a restore brings back the parameters with fresh moments and the step
count at 0, and the run asserts that the last loss is below the first.
Where the JAX package donates the old buffers to the jitted step and
builds new ones on restore, the port updates the live parameters and
moments in place and restores into them.  Each step moves its batch to
the device in one copy and reads the loss and the gradient norm back in
one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.store import ShardedTokenStore, write_token_store
from repro_torch.kernels._cuda import resolve_device
from repro_torch.models import api
from repro_torch.models.convert import load_params_, params_tree
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.fault_tolerance import FTConfig, TrainingSupervisor
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainConfig, make_train_step

HOSTS = 4             # the supervisor's hosts


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` returns: each step's loss and gradient norm and
    host wall (replayed steps included, in the order they ran), the
    supervisor's event log, the steps done, the run's wall and tokens/s
    (over ``--steps``, as the JAX package counts them), and each
    checkpoint save's and restore's wall and bytes."""
    losses: list
    grad_norms: list
    step_walls_s: list
    log: list
    steps: int
    wall_s: float
    tokens_per_s: float
    checkpoints: dict


def run(cfg, args, device=None, *, init=0) -> TrainRun:
    """Train ``cfg`` as ``args`` (the flags of :func:`parse_args`) say, on
    ``device`` (the card unless named), from ``init_params`` of ``init``:
    seed 0 (the JAX package's draw) unless a seed or a
    ``torch.Generator`` is given."""
    device = resolve_device(device)
    os.makedirs(args.workdir, exist_ok=True)
    print(f"[train] {cfg.name} smoke={args.smoke} device={device}")

    # data: build a synthetic store if none given (deterministic, replayable)
    data_dir = args.data or os.path.join(args.workdir, "data")
    if not os.path.exists(os.path.join(data_dir, "offsets.npy")):
        rng = np.random.default_rng(0)
        samples = [rng.integers(0, cfg.vocab, rng.integers(64, 512))
                   .astype(np.int32) for _ in range(2048)]
        write_token_store(data_dir, samples)
    store = ShardedTokenStore(data_dir, profile="azure_ssd")
    print(f"[data] sample index: {store.tune.design.describe()}")

    tcfg = TrainConfig(microbatches=args.microbatches)
    params = api.init_params(cfg, init, device)
    params.requires_grad_(True)
    live = {"params": params,
            "opt": adamw_init(dict(params.named_parameters()),
                              tcfg.optimizer)}
    step_fn = make_train_step(cfg, tcfg)
    ckpt = {"save_s": [], "save_bytes": [], "restore_s": [],
            "restore_bytes": []}

    def save(state, step):
        t0 = time.perf_counter()
        meta = save_checkpoint(args.workdir, params_tree(cfg, state["params"]),
                               step=step, profile="azure_ssd")
        ckpt["save_s"].append(time.perf_counter() - t0)
        ckpt["save_bytes"].append(meta["blob_bytes"])

    def restore(step):
        t0 = time.perf_counter()
        tree, stats = restore_checkpoint(args.workdir, api.param_specs(cfg),
                                         step=step)
        print(f"[restore] step={step} bytes_read={stats['bytes_read']}")
        # the live buffers take the restored leaves, and the moments start
        # afresh, as the JAX package's restore builds them
        load_params_(cfg, live["params"], tree)
        opt = live["opt"]
        for t in (*opt["m"].values(), *opt["v"].values()):
            t.zero_()
        opt["step"] = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ckpt["restore_s"].append(time.perf_counter() - t0)
        ckpt["restore_bytes"].append(stats["bytes_read"])
        return live

    sup = TrainingSupervisor(args.workdir, [f"host{i}" for i in range(HOSTS)],
                             FTConfig(checkpoint_every=args.ckpt_every),
                             save, restore)
    it = store.batch_iterator(args.batch, args.seq, seed=0)
    losses, gnorms, walls = [], [], []

    def one_step(state, step):
        ts = time.perf_counter()
        batch = next(it)
        both = torch.from_numpy(np.stack([batch["tokens"], batch["labels"]]))
        both = both.to(device)
        _, _, m = step_fn(state["params"], state["opt"],
                          {"tokens": both[0], "labels": both[1]})
        loss, gnorm = torch.stack([m["loss"], m["grad_norm"]]).tolist()
        losses.append(loss)
        gnorms.append(gnorm)
        walls.append(time.perf_counter() - ts)
        if step % 5 == 0:
            print(f"[step {step}] loss={loss:.4f} gnorm={gnorm:.3f}")
        return state

    t0 = time.time()
    _, steps, log = sup.run(live, one_step, n_steps=args.steps)
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"[done] {steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss must decrease"
    store.close()
    return TrainRun(losses=losses, grad_norms=gnorms, step_walls_s=walls,
                    log=log, steps=steps, wall_s=dt, tokens_per_s=tok_s,
                    checkpoints=ckpt)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch-train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data", default=None, help="token store dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    return run(cfg, args, args.device)


if __name__ == "__main__":
    main()
