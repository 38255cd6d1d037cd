"""End-to-end training example on PyTorch/CUDA with fault injection.

Trains a reduced qwen3 on a synthetic token store (attention forward
through the hand-written flash-attention kernel on the card, its
gradient in PyTorch ops), checkpoints through the AirIndex manifest,
injects a host failure mid-run, and shows the supervisor restarting from
the latest checkpoint with an elastically shrunk host set.  Loss must
decrease end to end.

Run:  PYTHONPATH=src python examples/torch/train_llm.py [steps]
      [--device cpu]
(the card by default; with no card and no ``--device`` it raises).
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, "src")

from repro_torch.configs import get_config
from repro_torch.data.store import ShardedTokenStore, write_token_store
from repro_torch.kernels._cuda import resolve_device
from repro_torch.models import api
from repro_torch.models.convert import load_params_, params_tree
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.fault_tolerance import (FTConfig, TrainingSupervisor,
                                               elastic_mesh_shape)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainConfig, make_train_step

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("steps", nargs="?", type=int, default=40)
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
device = resolve_device(args.device)
STEPS = args.steps
workdir = tempfile.mkdtemp(prefix="airindex-train-")

cfg = get_config("qwen3-14b", smoke=True)
print(f"== training reduced {cfg.name}: {cfg.n_layers}L d{cfg.d_model} "
      f"on {device} ==")

data_dir = os.path.join(workdir, "data")
rng = np.random.default_rng(0)
# learnable structure: repeated n-gram patterns
pats = [rng.integers(0, cfg.vocab, 16).astype(np.int32) for _ in range(8)]
samples = [np.concatenate([pats[i % 8]] * int(rng.integers(4, 16)))
           for i in range(512)]
write_token_store(data_dir, samples)
store = ShardedTokenStore(data_dir, profile="azure_ssd")
print(f"[data] index: {store.tune.design.describe()}")

tcfg = TrainConfig(microbatches=1)
params = api.init_params(cfg, 0, device)    # the JAX package's seed-0 draw
params.requires_grad_(True)
live = {"params": params,
        "opt": adamw_init(dict(params.named_parameters()), tcfg.optimizer)}
step_fn = make_train_step(cfg, tcfg)
it = store.batch_iterator(4, 64, seed=0)
losses = []


def save(state, step):
    meta = save_checkpoint(workdir, params_tree(cfg, state["params"]),
                           step=step, profile="azure_ssd")
    print(f"[ckpt] step={step} blob={meta['blob_bytes']}B "
          f"manifest={meta['index_design']}")


def restore(step):
    # the template is the specs' tree; the live buffers take the restored
    # leaves in place
    tree, stats = restore_checkpoint(workdir, api.param_specs(cfg),
                                     step=step)
    print(f"[restore] step={step} bytes={stats['bytes_read']} "
          f"reads={stats['reads']}")
    load_params_(cfg, live["params"], tree)
    # fresh moments, as the JAX example builds them after a failure
    live["opt"] = adamw_init(dict(live["params"].named_parameters()),
                             tcfg.optimizer)
    return live


sup = TrainingSupervisor(workdir, [f"host{i}" for i in range(4)],
                         FTConfig(checkpoint_every=10), save, restore)
killed = {"done": False}


def one_step(state, step):
    if step == 25 and not killed["done"]:
        print("[inject] killing host2 at step 25")
        sup.monitor.kill("host2")
        killed["done"] = True
    batch = next(it)
    both = torch.from_numpy(np.stack([batch["tokens"], batch["labels"]]))
    both = both.to(device)
    _, _, m = step_fn(state["params"], state["opt"],
                      {"tokens": both[0], "labels": both[1]})
    losses.append(float(m["loss"]))
    if step % 5 == 0:
        print(f"[step {step:3d}] loss={losses[-1]:.4f}")
    return state


t0 = time.time()
state, steps, log = sup.run(live, one_step, STEPS)
events = [e["event"] for e in log]
new_mesh = elastic_mesh_shape(len(sup.monitor.hosts), 4, 2)
print(f"== done: {steps} steps in {time.time() - t0:.1f}s; "
      f"events={sorted(set(events))} ==")
print(f"surviving hosts={len(sup.monitor.hosts)} -> elastic mesh {new_mesh}")
print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
assert "failure" in events and "restart" in events
assert losses[-1] < losses[0], "loss must decrease"
store.close()
print("OK")
