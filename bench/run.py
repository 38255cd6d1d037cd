"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) is found by name
with its files under ``bench/``.  The weights and the traffic are made on
the card from ``--seed``; every shape the window uses is warmed up as part
of set-up; the window lasts ``--seconds``; the reference then judges what
the window produced.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and, with
``--trace 1``, ``breakdown``); the compared numbers close standard error,
each beside its limit, and the result line under ``checks``.

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of the
window.  A run exits non-zero and prints no result without the cards the
cell asks for, or where a module of JAX or of the JAX package is loaded.
"""
import argparse
import json
import sys
import time

STARTED = time.time()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib import guard  # noqa: E402

guard.prepare_process()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded at start: {found}", file=sys.stderr)
        return 3
    from benchlib import check, manifest, runner
    try:
        cell = manifest.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"no cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    problem = guard.card_problem(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 4
    result, numbers, _ = runner.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        started=min(STARTED, runner.process_start()))
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded by the run: {found}",
              file=sys.stderr)
        return 3
    for line in check.lines(numbers):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
