"""One traced run of a benchmark cell, read through the program's own spans
as well as through the harness's ranges.

    python3 bench/probes/spans.py --workload grok-1.decode --seed 4300000013 --seconds 51

Runs the cell exactly as ``bench/run.py --trace 1`` does (the same
``runner.run_cell``, drivers, profiler window and reference), keeps the
trace's events, and prints one JSON line: the run's per-layer metrics,
the seven numbers of the program's spans (``benchlib.spans.quantities``)
with each span's entries, device time, device operations and idle time,
the traced window's end-to-end numbers, what reading the trace cost, and
the comparisons the spans are held to in the same run:

- the idle time inside the serving step against the window's whole idle;
- the MoE layer's four spans inside ``moe_ffn`` against the harness's
  ``moe_ffn_ms.decode``, and ``moe.aux_loss`` (outside ``moe_ffn``) a step;
- ``attn.flash`` / ``attn.decode`` against the harness's ranges around the
  same calls;
- every field of the harness's summary but its idle-gap names, computed
  with and without the program's spans among the events.

``benchlib.trace`` does not read the program's spans, so the benchmark's
own runs report none of these numbers."""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

STARTED = time.time()

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from benchlib import guard  # noqa: E402

guard.prepare_process()

#: the program's spans inside the harness's ``moe_ffn`` range
MOE_FFN = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def rel(a, b):
    return None if a is None or not b else a / b - 1.0


def probe(cell, seed: int, seconds: float, device=None,
          started: float | None = None) -> dict:
    """Run ``cell`` traced through ``runner.run_cell`` → the line's
    fields (``spans`` None where the trace holds no device operation)."""
    from benchlib import manifest, runner, trace
    from benchlib import spans as S
    started = time.time() if started is None else started
    kept = {}
    read_events, load_driver = trace.kineto_events, manifest.load_driver
    per_layer = runner.per_layer

    def keep_events(prof):
        kept["events"] = read_events(prof)
        return kept["events"]

    def keep_window(kind):
        drv = load_driver(kind)
        measure = drv.measure

        def kept_measure(run, st):
            kept["tracer"] = run.tracer
            kept["window"] = measure(run, st)
            return kept["window"]

        drv.measure = kept_measure
        return drv

    def keep_reading(cell, reading):
        kept["reading"] = reading
        return per_layer(cell, reading)

    trace.kineto_events = keep_events
    manifest.load_driver = keep_window
    runner.per_layer = keep_reading
    try:
        result, _, _ = runner.run_cell(cell, seed, seconds, True,
                                       device=device, started=started)
    finally:
        trace.kineto_events = read_events
        manifest.load_driver = load_driver
        runner.per_layer = per_layer
    run_s = time.time() - started
    events, reading = kept.get("events") or [], kept["reading"]
    work, kind = reading.work, cell.driver
    t0 = time.perf_counter()
    ps = S.reduce_spans(events)
    spans_s = time.perf_counter() - t0
    got = S.quantities(ps, work, reading.peaks, kind)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    cmp = {"program_idle_over_device_idle": rel(
        got.get(f"program_idle.{kind}"), m.get(f"device_idle.{kind}"))}
    if kind == "prefill":
        cmp["span_flash_roofline_vs_flash_roofline"] = rel(
            got.get("span_flash_roofline.prefill"),
            m.get("flash_roofline.prefill"))
    else:
        inside = S.ms_per(ps, MOE_FFN, work, "steps")
        cmp.update(
            moe_spans_in_moe_ffn_ms=inside,
            moe_spans_vs_moe_ffn_ms=rel(inside, m.get("moe_ffn_ms.decode")),
            aux_loss_ms=S.ms_per(ps, ("moe.aux_loss",), work, "steps"),
            span_decode_attn_roofline_vs_decode_attn_roofline=rel(
                got.get("span_decode_attn_roofline.decode"),
                m.get("decode_attn_roofline.decode")))
    # the harness's summary without the program's spans among the events
    t0 = time.perf_counter()
    summary = reading.summary
    bare = trace.reduce_events([e for e in events
                                if not e.name.startswith(S.PROGRAM)])
    cmp["summary_fields_changed"] = None if summary is None or bare is None \
        else [f.name for f in dataclasses.fields(summary)
              if f.name != "idle_gaps"
              and getattr(summary, f.name) != getattr(bare, f.name)]
    cmp["range_device_s"] = summary.range_device_s if summary else None
    cmp["range_device_s_without_spans"] = bare.range_device_s if bare else None
    cmp["idle_gaps_without_spans"] = bare.idle_gaps if bare else None
    return {"workload": cell.name, "seed": seed,
            "correct": result["correct"], "metrics": m, "span_metrics": got,
            "spans": {n: dataclasses.asdict(s)
                      for n, s in sorted(ps.spans.items())} if ps else None,
            "compare": cmp, "traced_end_to_end": kept["window"].end_to_end,
            "trace_timing": dict(kept["tracer"].timing, spans_s=spans_s,
                                 bare_reduce_s=time.perf_counter() - t0,
                                 run_s=run_s),
            "device": result["device"],
            "power_limit_w": result.get("power_limit_w"),
            "breakdown": result.get("breakdown")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded at start: {found}", file=sys.stderr)
        return 3
    from benchlib import manifest, runner
    cell = manifest.load_cell(args.workload)
    problem = guard.card_problem(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 4
    out = probe(cell, args.seed, args.seconds,
                started=min(STARTED, runner.process_start()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
