"""Prefill traffic: one client in a closed loop, one prompt a call.

Parameters (``params`` of a cell's file):

- ``min_len``, ``max_len``: prompt lengths are log-uniform between them;
- ``lengths``: how many distinct lengths a cycle holds.  Every seed sends
  the same lengths, the quantiles ``(i + 1/2) / lengths`` of the
  log-uniform law, each once a cycle, in an order the seed shuffles anew
  every cycle; token ids are drawn from the seed on the card, distinct in
  every request of a run;
- ``cycles``: how many cycles of prompts set-up draws (the window wraps
  round them);
- ``check_requests``: how many completed requests the reference judges:
  the longest and others drawn from the seed.

A request is timed from the call into the program until its first token
(the greedy argmax of the last position's logits) is on the host: that is
its time to first token.  The window runs until the first request that
ends past ``--seconds``; the rate is every completed request's prompt
tokens over the window.  Set-up sends each distinct length once.

The program's entry is ``serve.serve_step.make_prefill_step``.  The
compared numbers: ``greedy_gap``, the widest gap by which a served token's
reference logit lies below the reference's best, and ``logit_err``, the
largest difference of a judged request's last-position logits from the
reference's, over the standard deviation of the reference's.  A cell
compares those its ``limits`` name."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import flops, program
from benchlib.check import compared, spread
from benchlib.runner import Window
from reference import transformer as R
from reference.precision import Precision


def lengths(p: dict) -> list:
    lo, hi, n = int(p["min_len"]), int(p["max_len"]), int(p["lengths"])
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def schedule(p: dict, seed: int) -> list:
    """The lengths of every request of the pool, cycle by cycle."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    base = np.array(lengths(p))
    return [int(L) for _ in range(int(p["cycles"]))
            for L in rng.permutation(base)]


def setup(run):
    p, s, dev = run.cell.params, run.shape, run.device
    from repro_torch.models import transformer
    from repro_torch.serve import serve_step
    cfg, model = program.build_model(s, run.seed, dev)
    run.tracer.wrap(transformer, "blocked_attention", "flash")
    sched = schedule(p, run.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(run.seed) * 7919 + 1)
    pool = torch.randint(0, s.vocab, (sum(sched),), generator=gen,
                         device=dev)
    starts = np.concatenate([[0], np.cumsum(sched)[:-1]])
    prefill = serve_step.make_prefill_step(cfg)
    n = int(p["lengths"])
    for i in range(n):                  # every distinct length, once
        L = sched[i]
        ids = pool[starts[i]:starts[i] + L].view(1, L)
        int(prefill(model, {"tokens": ids}).argmax(-1))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"model": model, "prefill": prefill, "pool": pool,
            "sched": sched, "starts": starts}


def measure(run, st) -> Window:
    model, prefill, pool = st["model"], st["prefill"], st["pool"]
    sched, starts = st["sched"], st["starts"]
    done = []                           # (request index, ttft s, token)
    logits_kept = []
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    i = 0
    while True:
        k = i % len(sched)
        L = sched[k]
        ids = pool[starts[k]:starts[k] + L].view(1, L)
        ts = time.perf_counter()
        logits = prefill(model, {"tokens": ids})
        tok = int(logits.argmax(-1))
        te = time.perf_counter()
        done.append((k, te - ts, tok))
        logits_kept.append(logits)
        i += 1
        if te >= deadline:
            break
    window = te - t0
    lens = [sched[k] for k, _, _ in done]
    ttft = np.array([t for _, t, _ in done])
    s = run.shape
    work = {"requests": len(done), "prompt_tokens": int(sum(lens)),
            "model_flops": sum(flops.prefill_flops(s, L) for L in lens),
            "attn_flops": sum(s.layers * flops.attn_flops(
                s, flops.causal_pairs(L)) for L in lens)}
    e2e = {"prefill_tokens_per_s": sum(lens) / window,
           "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
           "ttft_p50_ms": float(np.median(ttft)) * 1e3}
    run.log(f"window {window:.3f} s, {len(done)} requests, "
            f"{sum(lens)} prompt tokens; ttft p50 "
            f"{e2e['ttft_p50_ms']:.3f} ms p95 {e2e['ttft_p95_ms']:.3f} ms")
    return Window(end_to_end=e2e, attempted=len(done), failed=0, work=work,
                  keep={"done": done, "logits": logits_kept})


def sample(done: list, sched: list, n: int, seed: int) -> list:
    """Positions in ``done`` of the judged requests: the first of the
    longest, and ``n - 1`` others drawn from the seed."""
    longest = max(range(len(done)), key=lambda j: (sched[done[j][0]], -j))
    rest = [j for j in range(len(done)) if j != longest]
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[j] for j in sorted(pick)]


def judge(run, st, window: Window):
    """Free the program, then run the reference over the judged
    requests → (numbers, the control's numbers where ``run.control``)."""
    done, kept = window.keep["done"], window.keep["logits"]
    sched, starts, pool = st["sched"], st["starts"], st["pool"]
    picks = sample(done, sched, int(run.cell.params["check_requests"]),
                   run.seed)
    judged = [(done[j][0], done[j][2], kept[j].float()[0]) for j in picks]
    del st["model"], st["prefill"], kept, window.keep["logits"]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    s = run.shape
    t0 = time.perf_counter()
    gaps, errs, c_gaps, c_errs = [], [], [], []
    for k, tok, prog in judged:
        L = sched[k]
        ids = pool[starts[k]:starts[k] + L].view(1, L)
        args = (s, run.seed, ids, torch.arange(1, L + 1), [(0, L)], [0],
                [L - 1])
        ref = R.forward(*args)
        sd = float(ref.std())
        gaps.append(float(R.greedy_gaps(ref, [tok])[0]))
        errs.append(float((prog - ref[0]).abs().max()) / sd)
        if run.control:
            low = R.forward(*args, prec=Precision("fp8"))
            c_gaps.append(float(R.greedy_gaps(ref, low.argmax(-1))[0]))
            c_errs.append(float((low - ref).abs().max()) / sd)
    run.log(f"reference over {len(judged)} requests "
            f"({sum(sched[k] for k, _, _ in judged)} tokens): "
            f"{time.perf_counter() - t0:.3f} s")
    run.log("program: " + spread(errs, gaps))
    if run.control:
        run.log("control: " + spread(c_errs, c_gaps))
    numbers = compared({"greedy_gap": max(gaps), "logit_err": max(errs)},
                       run.cell.limits)
    control = compared({"greedy_gap": max(c_gaps), "logit_err": max(c_errs)},
                       run.cell.limits) if run.control else []
    return numbers, control
