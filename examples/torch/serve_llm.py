"""End-to-end serving driver on PyTorch/CUDA: batched requests against a
small LM.

The paper is a lookup/serving paper, so the e2e driver serves: a reduced
zamba2 (hybrid SSM+attention — O(1) decode state; its shared attention
block decodes through the hand-written decode-attention kernel on the
card) handles a batch of requests with greedy decoding, a paged KV cache
whose page table is AirTune-tuned for the HBM tier, and per-step
continuous batching (finished sequences are replaced by queued requests).

Run:  PYTHONPATH=src python examples/torch/serve_llm.py [n_requests]
      [steps] [--device cpu]
(the card by default; with no card and no ``--device`` it raises).
"""
import argparse
import sys
import time

import numpy as np
import torch

sys.path.insert(0, "src")

from repro_torch.configs import get_config
from repro_torch.kernels._cuda import resolve_device
from repro_torch.models import api
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.serve_step import make_decode_step

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("n_requests", nargs="?", type=int, default=12)
ap.add_argument("steps", nargs="?", type=int, default=24)
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
device = resolve_device(args.device)
N_REQ, STEPS = args.n_requests, args.steps
BATCH = 4
MAX_LEN = 128

cfg = get_config("zamba2-1.2b", smoke=True)
print(f"== serving {cfg.name} (reduced: {cfg.n_layers}L d{cfg.d_model}) "
      f"on {device} ==")
params = api.init_params(cfg, 0, device)    # the JAX package's seed-0 draw
decode = make_decode_step(cfg)

# request queue: random prompts of 4-12 tokens
rng = np.random.default_rng(0)
queue = [rng.integers(1, cfg.vocab, rng.integers(4, 12)).astype(np.int32)
         for _ in range(N_REQ)]
done = []

# paged KV pool + AirTune'd page table for the HBM tier
pool = PagedKVCache(n_pages=256)

state = api.init_decode_state(cfg, params, BATCH, MAX_LEN)
slots = [None] * BATCH          # per-slot (request_id, tokens, generated)
next_req = 0
pos = 0
t0 = time.perf_counter()
tokens_out = 0

for step in range(STEPS):
    # continuous batching: fill free slots from the queue
    for b in range(BATCH):
        if slots[b] is None and next_req < len(queue):
            slots[b] = {"id": next_req, "prompt": list(queue[next_req]),
                        "fed": 0, "out": []}
            pool.add_sequence(next_req)
            next_req += 1
    # one token per slot: prompt token if any left, else last generated
    feed = np.zeros((BATCH, 1), np.int32)
    for b, s in enumerate(slots):
        if s is None:
            continue
        if s["fed"] < len(s["prompt"]):
            feed[b, 0] = s["prompt"][s["fed"]]
        else:
            feed[b, 0] = s["out"][-1] if s["out"] else 1
    logits, state = decode(params, {"tokens": torch.from_numpy(feed).to(
        device)}, state, pos)
    nxt = logits.argmax(-1).cpu().numpy()
    pos += 1
    for b, s in enumerate(slots):
        if s is None:
            continue
        pool.append_tokens(s["id"], 1)
        if s["fed"] < len(s["prompt"]):
            s["fed"] += 1
        else:
            s["out"].append(int(nxt[b]))
            tokens_out += 1
            if len(s["out"]) >= 8:       # request complete
                done.append(s)
                pool.release(s["id"])
                slots[b] = None

dt = time.perf_counter() - t0
print(f"{STEPS} decode steps, {tokens_out} tokens generated, "
      f"{len(done)} requests completed, "
      f"{tokens_out / dt:.1f} tok/s ({device})")

print("== AirTune'd page tables per tier (Fig. 1 in the serving stack) ==")
pool2 = PagedKVCache(n_pages=65536)
for s in range(512):
    pool2.add_sequence(s)
    pool2.append_tokens(s, int(rng.integers(256, 2048)))
for tier in ("hbm", "host_dram"):
    stats = pool2.modeled_lookup_cost(tier, device=device)
    print(f"[{tier}] {stats['design']}")
    print(f"[{tier}] modeled lookup: tuned={stats['tuned_us']:.2f}us vs "
          f"flat-table={stats['flat_us']:.2f}us")
# fat-fast HBM ⇒ no index (read the whole table); offloaded host-DRAM
# tables ⇒ AirTune builds a real hierarchy — the paper's Fig. 1 adapted
print("OK")
