"""Decode traffic: a batch of sequences that each take one new token a
step, their contexts built during set-up.

Parameters (``params`` of a cell's file):

- ``batch``: the sequences decoded together, every step;
- ``context``: the tokens of each sequence's context, drawn from the seed
  and fed through the program's own decode step ``chunk`` tokens at a
  time during set-up;
- ``max_len``: the cache's positions; a step at position ``max_len - 1``
  is followed by one at ``context`` again (the window replays the second
  half of the cache, which the cache's length masks past the position);
- ``check_positions``, ``margin_floor``: the reference judges every
  sequence's token at the steps :func:`judged_steps` names, across the
  first lap, the wrap, and the window's last step; ``margin_floor`` is
  the routing margin a token needs for its widest numbers to count.

Each step feeds every sequence its previous greedy token, which stays on
the card.  The window runs steps until ``--seconds`` have passed, then
waits for the card; the rate is every step's new tokens over the window.
Set-up runs the first step three times (it rewrites the same cache
position), so nothing is built in the window.

The program's entry is ``serve.serve_step.make_decode_step``.  The
compared numbers, over the judged tokens: ``greedy_gap_p90``, the 90th
percentile of the gaps by which a served token's reference logit lies
below the reference's best; ``logit_err_p90``, the 90th percentile of
each token's largest logit difference from the reference over the
standard deviation of the reference's logits; ``greedy_gap_clear_max``
and ``logit_err_clear_max``, the widest of each over the tokens whose
routing margin in the reference (the least over the layers of the gap
between a token's k-th and next router logits, 0 at its expert's
capacity edge) is at least ``margin_floor``; and ``near_tie_share``, the
share of judged tokens the floor leaves out.  Below the floor, bfloat16
routes a token to the other side of a near-tie and its logits differ
whole, so those tokens count in the percentiles alone."""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import flops, program
from benchlib.check import compared, spread, tail
from benchlib.runner import Window
from reference import transformer as R
from reference.precision import Precision

WARM_STEPS = 3


def judged_steps(p: dict, seed: int) -> set:
    """The steps whose every token the reference judges, of those the
    window reaches: the first, the last of the first lap (the cache full
    to ``max_len``), the first after the wrap (every entry past its
    position stale), and ``check_positions`` others drawn from the seed
    over the first lap.  :func:`measure` adds the window's last step."""
    lap = int(p["max_len"]) - int(p["context"])
    rng = np.random.default_rng([int(seed), 0xDEC0])
    k = min(int(p["check_positions"]), max(lap - 2, 0))
    others = rng.choice(np.arange(1, lap - 1), size=k, replace=False)
    return {0, lap - 1, lap, *map(int, others)}


def setup(run):
    p, s, dev = run.cell.params, run.shape, run.device
    from repro_torch.models import api, transformer
    from repro_torch.serve import serve_step
    cfg, model = program.build_model(s, run.seed, dev)
    run.tracer.wrap(transformer, "decode_attention", "decode_attn")
    run.tracer.wrap(transformer, "moe_ffn", "moe_ffn")
    B, ctx_len, chunk = int(p["batch"]), int(p["context"]), int(p["chunk"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(run.seed) * 7919 + 2)
    ctx = torch.randint(0, s.vocab, (B, ctx_len), generator=gen, device=dev)
    cache = api.init_decode_state(cfg, model, B, int(p["max_len"]))
    decode = serve_step.make_decode_step(cfg)
    logits = None
    for c in range(0, ctx_len, chunk):
        logits, cache = decode(model, {"tokens": ctx[:, c:c + chunk]},
                               cache, c)
    first = logits.argmax(-1)
    del logits
    for _ in range(WARM_STEPS):
        decode(model, {"tokens": first[:, None]}, cache, ctx_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"model": model, "decode": decode, "cache": cache, "ctx": ctx,
            "first": first}


def measure(run, st) -> Window:
    p, s = run.cell.params, run.shape
    model, decode, cache = st["model"], st["decode"], st["cache"]
    ctx_len, max_len = int(p["context"]), int(p["max_len"])
    B = int(p["batch"])
    keep_at = judged_steps(p, run.seed)
    tok = st["first"]
    served, kept = [], {}
    kv_lens = []
    pos = ctx_len
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while time.perf_counter() < deadline:
        logits, cache = decode(model, {"tokens": tok[:, None]}, cache, pos)
        tok = logits.argmax(-1)
        if len(served) in keep_at:
            kept[len(served)] = logits
        served.append(tok)
        kv_lens.append(pos + 1)
        pos = pos + 1 if pos + 1 < max_len else ctx_len
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    window = time.perf_counter() - t0
    steps = len(served)
    kept[steps - 1] = logits
    work = {"steps": steps, "tokens": steps * B,
            "step_flops": [flops.decode_step_flops(s, B, kv)
                           for kv in kv_lens],
            "step_bytes": [flops.decode_step_bytes(s, B, kv)
                           for kv in kv_lens],
            "attn_bytes": sum(s.layers * flops.decode_attn_bytes(s, B, kv)
                              for kv in kv_lens)}
    run.log(f"window {window:.3f} s, {steps} steps of {B} tokens "
            f"({steps * B / window:.3f} tokens/s)")
    return Window(end_to_end={"decode_tokens_per_s": steps * B / window},
                  attempted=steps * B, failed=0, work=work,
                  keep={"served": served, "logits": kept})


def step_input(st, served, i: int) -> torch.Tensor:
    """The tokens step ``i`` fed: set-up's greedy token, then each step's
    output."""
    return st["first"] if i == 0 else served[i - 1]


def judge(run, st, window: Window):
    """Free the program, then run the reference over every sequence's
    context and, for each lap that holds a judged step, that lap's fed
    tokens up to its last judged step → (numbers, the control's numbers
    where ``run.control``).

    The laps follow one another in the reference's sequence: a lap's
    tokens sit at the cache positions the program wrote them to and see
    the context and their own lap up to themselves, never an earlier
    lap's entries, which the program's cache still holds past the
    position and masks by its length."""
    p, s, dev = run.cell.params, run.shape, run.device
    ctx_len, chunk = int(p["context"]), int(p["chunk"])
    lap = int(p["max_len"]) - ctx_len
    served = window.keep["served"]
    kept = {j: t.float() for j, t in window.keep["logits"].items()}
    steps = sorted(kept)
    del st["model"], st["decode"], st["cache"], window.keep["logits"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    B = st["ctx"].shape[0]
    pieces = [st["ctx"]]
    pos = torch.arange(ctx_len)
    # a context chunk sees itself whole
    kv_end = [torch.clamp((pos // chunk + 1) * chunk, max=ctx_len)]
    positions, hide = [pos], [torch.zeros(ctx_len, 2, dtype=torch.long)]
    calls = [(c, min(c + chunk, ctx_len)) for c in range(0, ctx_len, chunk)]
    index = {}
    S = ctx_len
    for L in sorted({j // lap for j in steps}):
        first, last = L * lap, max(j for j in steps if j // lap == L)
        n = last - first + 1
        pieces.append(torch.stack([step_input(st, served, i)
                                   for i in range(first, last + 1)], dim=1))
        idx = S + torch.arange(n)
        kv_end.append(idx + 1)                    # a step sees up to itself
        positions.append(ctx_len + torch.arange(n))
        hide.append(torch.tensor([[ctx_len, S]]).expand(n, 2))
        calls += [(q, q + 1) for q in idx.tolist()]
        index.update({i: S + i - first for i in range(first, last + 1)})
        S += n
    inputs = torch.cat(pieces, dim=1)                 # (B, S)
    rows = [b for _ in steps for b in range(B)]
    at = [index[j] for j in steps for _ in range(B)]
    chosen = torch.cat([served[j] for j in steps])
    prog = torch.cat([kept[j] for j in steps])
    t0 = time.perf_counter()
    args = (s, run.seed, inputs, torch.cat(kv_end), calls, rows, at)
    where = {"positions": torch.cat(positions), "hide": torch.cat(hide)}
    look = {}
    ref = R.forward(*args, stats=look, **where)
    sd = ref.std(dim=-1)
    errs = (prog - ref).abs().amax(-1) / sd
    gaps = R.greedy_gaps(ref, chosen)
    judged = (torch.as_tensor(rows), torch.as_tensor(at))
    margin = look["margin"].view(B, S)[judged].cpu()
    ranks = look["ranks"].view(B, S)[judged].cpu()
    floor = float(p["margin_floor"])
    clear = margin >= floor
    run.log(f"judged steps {steps!r} (laps of {lap}), {len(rows)} tokens, "
            f"{int((~clear).sum())} with a routing margin under {floor!r}; "
            f"median margin {float(margin.median())!r}")
    run.log("program: " + spread(errs, gaps))
    run.log("program's widest: " + widest(errs, gaps, margin, ranks))
    numbers = compared(decode_numbers(errs, gaps, clear), run.cell.limits)
    control = []
    if run.control:
        low = R.forward(*args, prec=Precision("fp8"), **where)
        c_errs = (low - ref).abs().amax(-1) / sd
        c_gaps = R.greedy_gaps(ref, low.argmax(-1))
        run.log("control: " + spread(c_errs, c_gaps))
        run.log("control's widest: " + widest(c_errs, c_gaps, margin, ranks))
        control = compared(decode_numbers(c_errs, c_gaps, clear),
                           run.cell.limits)
    run.log(f"reference over {B} sequences x {S} positions, "
            f"{len(rows)} judged tokens: {time.perf_counter() - t0:.3f} s")
    return numbers, control


def decode_numbers(errs, gaps, clear) -> dict:
    """The compared numbers over the judged tokens: the 90th percentiles
    of all, the widest of those whose routing margin clears the floor
    (NaN, which fails, where none does), and the share left out."""
    errs, gaps = errs.cpu(), gaps.cpu()
    none = float("nan")
    return {"greedy_gap_p90": tail(gaps), "logit_err_p90": tail(errs),
            "greedy_gap_clear_max": float(gaps[clear].max())
            if clear.any() else none,
            "logit_err_clear_max": float(errs[clear].max())
            if clear.any() else none,
            "near_tie_share": float((~clear).float().mean())}


def widest(errs, gaps, margin, ranks, n: int = 16) -> str:
    """The ``n`` largest logit errors and greedy gaps, each with its
    token's routing margin and capacity-edge distance, for the log:
    (value, margin, ranks) triples."""
    errs, gaps = errs.cpu(), gaps.cpu()
    out = []
    for name, v in (("logit_err", errs), ("greedy_gap", gaps)):
        top = torch.topk(v, min(n, v.numel())).indices
        out.append(f"{name} " + repr([(round(float(v[i]), 5),
                                       round(float(margin[i]), 5),
                                       int(ranks[i])) for i in top]))
    return "; ".join(out)
