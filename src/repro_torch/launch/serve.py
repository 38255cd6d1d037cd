"""Serving launcher of the port: a continuous-batching decode loop with
paged KV bookkeeping, on the card unless told otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --smoke --requests 8 --steps 32 [--device cpu]

:func:`run` is the loop of the JAX package's ``repro.launch.serve`` and
keeps its quirks, since parity with it is the point: every slot decodes
at one shared position ``pos`` (a request that joins late starts at the
current ``pos``), a slot's cache is not cleared when a new request takes
it, prompts are fed one token per step, and each request ends after 8
output tokens.  The loop is the same for every family: the decode state
is ``api.init_decode_state``'s (a KV cache, a recurrent state, or
whisper's cache over zero frames), one token a step.  ``--smoke`` defaults to on as there; ``--no-smoke`` reaches
the full config (the JAX package's flag cannot be turned off).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels._cuda import resolve_device
from repro_torch.models import api
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.serve_step import make_decode_step

OUT_TOKENS = 8        # output tokens per request
N_PAGES = 1024        # pages of the KV pool


@dataclasses.dataclass
class ServeRun:
    """What :func:`run` returns: each request's output tokens (by request
    id), the loop's counters and walls, the (batch, 1) token feed of
    every step, each step's logits when asked for, and the page table
    tuned for the ``h100_hbm`` tier (the card's measured memory) over the
    sequences still held at the end (None when none is)."""
    tokens: dict
    stats: dict
    feeds: list
    logits: list
    page_table: object


def make_queue(cfg, requests: int, seed: int) -> list:
    """The request prompts: 4..11 tokens each, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, int(rng.integers(4, 12)))
            .astype(np.int32) for _ in range(requests)]


@torch.no_grad()
def run(cfg, params, *, requests: int = 8, steps: int = 32, batch: int = 4,
        max_len: int = 128, device=None, seed: int = 0,
        keep_logits: bool = False) -> ServeRun:
    """Serve ``requests`` prompts with ``batch`` slots for ``steps`` decode
    steps on ``device`` (the card unless named; ``params`` must live
    there)."""
    device = resolve_device(device)
    if params.device.type != device.type:
        raise ValueError(f"params live on {params.device}, not {device}")
    if steps > max_len:
        raise ValueError(f"{steps} steps at one shared position need "
                         f"max_len >= {steps}, got {max_len}")
    decode = make_decode_step(cfg)
    queue = make_queue(cfg, requests, seed)
    pool = PagedKVCache(n_pages=N_PAGES)
    state = api.init_decode_state(cfg, params, batch, max_len)
    slots = [None] * batch
    outputs = {}
    feeds, kept, walls = [], [], []
    next_req, pos, out_tokens, completed = 0, 0, 0, 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        ts = time.perf_counter()
        for b in range(batch):
            if slots[b] is None and next_req < len(queue):
                slots[b] = {"id": next_req, "prompt": list(queue[next_req]),
                            "fed": 0, "out": []}
                pool.add_sequence(next_req)
                next_req += 1
        feed = np.zeros((batch, 1), np.int32)
        for b, s in enumerate(slots):
            if s is None:
                continue
            feed[b, 0] = (s["prompt"][s["fed"]] if s["fed"] < len(s["prompt"])
                          else (s["out"][-1] if s["out"] else 1))
        feeds.append(feed)
        logits, state = decode(params,
                               {"tokens": torch.from_numpy(feed).to(device)},
                               state, pos)
        nxt = logits.argmax(-1).cpu().numpy()      # waits for the step
        if keep_logits:
            kept.append(logits.float().cpu().numpy())
        pos += 1
        for b, s in enumerate(slots):
            if s is None:
                continue
            pool.append_tokens(s["id"], 1)
            if s["fed"] < len(s["prompt"]):
                s["fed"] += 1
            else:
                s["out"].append(int(nxt[b]))
                out_tokens += 1
                if len(s["out"]) >= OUT_TOKENS:
                    completed += 1
                    outputs[s["id"]] = s["out"]
                    pool.release(s["id"])
                    slots[b] = None
        walls.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    table = (pool.tune_table("h100_hbm", device=device) if pool.tables
             else None)
    stats = {"steps": steps, "out_tokens": out_tokens,
             "completed": completed, "wall_s": wall,
             "tokens_per_s": out_tokens / wall if wall > 0 else 0.0,
             "step_walls_s": walls, "device": str(device)}
    return ServeRun(tokens=outputs, stats=stats, feeds=feeds, logits=kept,
                    page_table=table)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    print(f"[serve] {cfg.name} (reduced={args.smoke}) on {device}")
    params = api.init_params(cfg, 0, device)
    res = run(cfg, params, requests=args.requests, steps=args.steps,
              batch=args.batch, max_len=args.max_len, device=device)
    st = res.stats
    print(f"[done] {args.steps} steps, {st['out_tokens']} tokens, "
          f"{st['completed']} requests complete, "
          f"{st['tokens_per_s']:.1f} tok/s")
    print("[page table]", res.page_table.design.describe()
          if res.page_table is not None else "(empty)")


if __name__ == "__main__":
    main()
