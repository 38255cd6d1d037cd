"""The readings the comparison's limits are set from, on the card.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

For each seed, in one process: a run of the cell (a short window at the
cell's own load and sizes), the reference over what it produced (the
program's reading), and the control: the reference in float8 in the
program's place, over the same prompts and served tokens (the control's
reading).  A limit lies between the largest of the program's readings and
the smallest of the control's.  Benchmark runs never run this; its lines
go to standard output as one JSON object a seed."""
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    from benchlib import manifest, runner
    cell = manifest.load_cell(args.workload)
    problem = guard.card_problem(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 4
    for seed in (int(s) for s in args.seeds.split(",")):
        result, numbers, control = runner.run_cell(
            cell, seed, args.seconds, False, control=True,
            started=time.time())
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "program": {n.name: n.value for n in numbers},
            "control": {n.name: n.value for n in control},
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "memory_peak_bytes": result["device"]["memory_peak_bytes"]}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
