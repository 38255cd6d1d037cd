"""The port's index examples (``examples/torch/``) run to their end on
the CPU (``--device cpu``: the kernels' plain versions), each with its
own ``assert``s: the spec round trips, batch atomicity across the hot
swap, the fleet's scatter-gather identity, the token store's round trip.

Where the JAX package's example prints a tuned design or a modeled cost
for a configured tier, it runs beside the port's on the same seeds
(``PYTHONHASHSEED`` fixed: the data generator's seed adds ``hash(name)``)
and the two print the same, walls, temporary paths and the pipelined
batches' measured I/O fraction, the roofline's bound that it decides and
the overlapped reads (the prefetch thread's timing) aside.  quickstart
and data_pipeline tune for a profile they measure on the local disk, and
the retune daemon's drift verdicts come from measured serving under live
threads, so those print what the disk and the scheduler give each run;
they are checked for their own assertions and final line.  The LLM examples are in
``test_torch_examples_llm.py``.
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: run-to-run noise in a line: walls, temporary paths, measured shares
NOISE = [(re.compile(r"/\S*airindex-\S*"), "<path>"),
         (re.compile(r"\d+\.\d+s\)"), "<wall>)"),
         (re.compile(r"roofline: \w+-bound"), "roofline: <measured>-bound"),
         (re.compile(r"io_fraction=[\d.]+"), "io_fraction=<measured>"),
         (re.compile(r"\d+ preads overlapped"), "<n> preads overlapped")]


def start(args, tmp_path, port=True):
    """Popen of one example from the repo root: the port's on the CPU, or
    the JAX package's (jax on the CPU)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    # one thread each: the examples' arrays are small, and the suite runs
    # them beside other workers
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PYTHONHASHSEED="0", TMPDIR=str(tmp_path),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    name, *rest = args
    path = os.path.join("examples", "torch" if port else "", f"{name}.py")
    cmd = [sys.executable, path, *rest] + (["--device", "cpu"] if port
                                           else [])
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def lines(text, drop=()):
    out = []
    for ln in text.splitlines():
        if any(ln.startswith(d) for d in drop):
            continue
        for pat, rep in NOISE:
            ln = pat.sub(rep, ln)
        out.append(ln)
    return out


#: example → (its last line, lines it must print, the port's own lines
#: left out of the comparison (None: no reference run))
EXAMPLES = {
    "quickstart": ("OK", ("ranked on cpu", "batched engine on cpu",
                          "ranges equal the disk walk's"), None),
    "data_pipeline": ("replay from step 5 matches sequential iteration: "
                      "OK (batch (8, 256) on cpu)", (), None),
    "retune_daemon": ("done.", ("mixed-epoch: 0  errors: []",), None),
    "serve_index": ("done.", ("descents on cpu:",), ("descents on cpu:",)),
    "serve_fleet": ("done.", ("identity ok",), ()),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_and_prints_what_the_reference_prints(name, tmp_path):
    last, expect, port_only = EXAMPLES[name]
    port = start([name], tmp_path / "port")
    ref = None if port_only is None else start([name], tmp_path / "ref",
                                               port=False)
    got = finish(port)
    assert got.splitlines()[-1] == last
    assert all(e in got for e in expect)
    if ref is not None:
        want = finish(ref)
        assert lines(got, port_only) == lines(want)
