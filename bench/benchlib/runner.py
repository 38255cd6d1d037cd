"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result.

A traffic driver (``bench/traffic/<kind>.py``) gives three functions:

- ``setup(run) → state``: the program, its weights and its inputs, every
  shape the window uses warmed up;
- ``measure(run, state) → Window``: the measured window;
- ``judge(run, state, window) → (numbers, control numbers)``: frees the
  program's state, runs the reference over what the window produced and
  returns the compared numbers (:class:`benchlib.check.Number`); the
  control's (the reference in float8 in the program's place) only where
  ``run.control``.

The runner times set-up from the process's start, reads the peak memory
once the window has closed, and hands the window's counts and the trace's
numbers to each per-layer metric's reader."""
from __future__ import annotations

import dataclasses
import math
import sys
import time

from . import check, manifest, peaks
from .shape import Shape
from .trace import Tracer


def process_start() -> float:
    """This process's start on the wall clock: now less its age (/proc's
    uptime less its start, to 10 ms), else the runner's import."""
    try:
        import os
        tick = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / tick)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


@dataclasses.dataclass
class Window:
    """What a driver's window gives the runner."""
    end_to_end: dict             # metric name → value
    attempted: int
    failed: int
    work: dict                   # counts over the window for the readers
    keep: dict = dataclasses.field(default_factory=dict)   # for judge


@dataclasses.dataclass
class Run:
    cell: manifest.Cell
    seed: int
    seconds: float
    tracer: Tracer
    device: object
    control: bool = False

    @property
    def shape(self) -> Shape:
        return Shape.from_config(self.cell.config)

    def log(self, msg: str) -> None:
        print(f"[bench {self.cell.name}] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the trace's summary (None without a
    usable trace), the window's counts and the card's peaks (None for a
    card the table lacks)."""
    summary: object
    work: dict
    peaks: dict | None


def per_layer(cell: manifest.Cell, reading: Reading) -> dict:
    out = {}
    for m in cell.per_layer:
        value = manifest.load_reader(m["name"]).read(reading)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(dev, count: int) -> dict:
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": dev.type, "kind": dev.type, "count": count,
            "memory_peak_bytes": 0}


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device=None, control: bool = False, started: float | None = None):
    """Run ``cell`` once → (result dict for the last line, the compared
    numbers, the control's numbers)."""
    import torch
    started = process_start() if started is None else started
    dev = torch.device(device or "cuda:0")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds),
              tracer=Tracer(trace), device=dev, control=control)
    drv = manifest.load_driver(cell.driver)
    state = drv.setup(run)
    setup_s = time.time() - started
    run.log(f"set-up {setup_s:.3f} s")
    with run.tracer.window():
        window = drv.measure(run, state)
    run.tracer.restore()
    dinfo = device_info(dev, cell.chips)
    numbers, control_numbers = drv.judge(run, state, window)
    del state
    result = {"correct": check.verdict(numbers),
              "attempted": int(window.attempted),
              "failed": int(window.failed)}
    kind = dinfo["kind"]
    if trace:
        summary = run.tracer.summary()
        run.log(f"trace: {run.tracer.timing}")
        reading = Reading(summary=summary, work=window.work,
                          peaks=peaks.peaks_for(kind))
        result["metrics"] = per_layer(cell, reading)
        if summary is not None:
            dinfo["busy_s"] = summary.busy_s
            dinfo["window_s"] = summary.window_s
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in summary.device_ops],
                "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    else:
        values = dict(window.end_to_end, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = dinfo
    if dev.type == "cuda":
        result["power_limit_w"] = peaks.power_limit_w()
    result["checks"] = check.as_dict(numbers)
    return result, numbers, control_numbers
