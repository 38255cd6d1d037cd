"""The program's own spans in a traced window, and the per-layer numbers
they give.

The program opens ``repro_torch/<name>`` profiler ranges around its serving
step (``serve.prefill``, ``serve.decode``), its attention calls
(``attn.flash``, ``attn.decode``) and the parts of its MoE layer
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
``moe.aux_loss``) while a profiler records (``repro_torch.spans``).  From
the same events as :func:`trace.reduce_events`, :func:`reduce_spans` gives
each span name its host entries, the device seconds and device operations
launched inside it (placed as :func:`trace._range_device_s` places a
harness range's), and the card's idle time inside it: the window's idle
gaps intersected with the union of the span's intervals on the window's
thread, whole, not only the gaps that begin there.  :func:`quantities`
turns those into the seven numbers the spans are for.

``trace.reduce_events`` does not call this module, so a benchmark run
reports none of the seven: ``bench/probes/spans.py`` runs a cell as the
benchmark does and reads them from its trace."""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from .trace import PREFIX, WINDOW, _range_device_s, _union

PROGRAM = "repro_torch/"

#: the MoE layer's spans other than the expert products
MOE_OVERHEAD = ("moe.route", "moe.dispatch", "moe.combine", "moe.aux_loss")


@dataclasses.dataclass
class SpanStats:
    calls: int                    # host entries
    device_s: float               # device seconds launched inside
    device_ops: int               # device operations launched inside
    idle_s: float                 # idle gaps inside, on the window's thread


@dataclasses.dataclass
class ProgramSpans:
    window_s: float
    spans: dict                   # span name → SpanStats


def reduce_spans(events: list) -> ProgramSpans | None:
    """Each program span's numbers over the window range, or None where
    the trace holds no window range or no device operation in it."""
    windows = [e for e in events if e.name == WINDOW and not e.device]
    if not windows:
        return None
    win = max(windows, key=lambda e: e.end - e.start)
    w0, w1 = win.start, win.end
    # device-side copies of ranges, the harness's or the program's, are
    # no operations
    ops = [e for e in events if e.device
           and not e.name.startswith((PREFIX, PROGRAM))
           and e.end > w0 and e.start < w1]
    if not ops:
        return None
    _, gaps = _union((max(e.start, w0), min(e.end, w1)) for e in ops)
    host = [e for e in events if not e.device]
    ranges = defaultdict(lambda: defaultdict(list))      # name → thread
    for e in host:
        if e.name.startswith(PROGRAM):
            ranges[e.name[len(PROGRAM):]][e.thread].append((e.start, e.end))
    dev_s = _range_device_s(ranges, host, ops)
    n_ops = _range_device_ops(ranges, host, ops)
    out = {name: SpanStats(
        calls=sum(len(v) for v in by.values()),
        device_s=dev_s.get(name, 0.0), device_ops=n_ops.get(name, 0),
        idle_s=_overlap(gaps, by.get(win.thread, [])) / 1e9)
        for name, by in ranges.items()}
    return ProgramSpans(window_s=(w1 - w0) / 1e9, spans=out)


def _range_device_ops(ranges, host, ops) -> dict:
    """The number of device operations of each range, placed as
    :func:`trace._range_device_s` places their time: those that start
    after the last operation launched before the range ended and before
    the first one launched after it."""
    launch = {e.correlation: e.start for e in host if e.correlation}
    tied = sorted((launch[op.linked], op.start, op.end) for op in ops
                  if op.linked in launch)
    if not tied:
        return {}
    at = [t for t, _, _ in tied]
    starts = sorted(op.start for op in ops)
    out = {}
    for name, by_thread in ranges.items():
        n = 0
        for spans in by_thread.values():
            for h0, h1 in spans:
                i = bisect.bisect_left(at, h0) - 1
                d0 = tied[i][2] if i >= 0 else starts[0]
                j = bisect.bisect_right(at, h1)
                d1 = tied[j][1] if j < len(tied) else starts[-1] + 1
                lo = bisect.bisect_left(starts, d0)
                n += max(bisect.bisect_left(starts, d1), lo) - lo
        out[name] = n
    return out


def _overlap(gaps, intervals) -> int:
    """Length of the sorted, disjoint ``gaps`` inside the union of
    ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total, i = 0, 0
    for g0, g1 in gaps:
        while i < len(merged) and merged[i][1] <= g0:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < g1:
            total += min(g1, merged[j][1]) - max(g0, merged[j][0])
            j += 1
    return total


def _stats(ps, name):
    s = ps.spans.get(name) if ps is not None else None
    return s if s is not None and s.calls else None


def _device_s(ps, name):
    s = _stats(ps, name)
    return s.device_s if s is not None and s.device_s > 0 else None


def idle_pct(ps, name: str) -> float | None:
    """Idle seconds inside the span ``name`` over the window, in %."""
    s = _stats(ps, name)
    if s is None or ps.window_s <= 0:
        return None
    return 100.0 * s.idle_s / ps.window_s


def ops_per_call(ps, name: str) -> float | None:
    """Device operations placed in the span ``name`` over its entries."""
    s = _stats(ps, name)
    return s.device_ops / s.calls if s is not None else None


def ms_per(ps, names, work: dict, key: str) -> float | None:
    """Device milliseconds inside the spans ``names`` (those present)
    per ``work[key]``."""
    ts = [t for t in (_device_s(ps, n) for n in names) if t is not None]
    if not ts or not work.get(key):
        return None
    return 1e3 * sum(ts) / work[key]


def roofline_pct(ps, name: str, work: dict, key: str, peaks: dict | None,
                 peak: str) -> float | None:
    """``work[key]`` over the device time inside the span ``name`` at the
    card's ``peak``, in %."""
    t = _device_s(ps, name)
    if t is None or peaks is None or key not in work:
        return None
    return 100.0 * work[key] / (t * peaks[peak])


def quantities(ps, work: dict, peaks: dict | None, kind: str) -> dict:
    """The spans' numbers for a ``prefill`` or ``decode`` window; those
    the trace cannot give are left out."""
    if kind == "prefill":
        got = {"program_idle.prefill": idle_pct(ps, "serve.prefill"),
               "span_flash_roofline.prefill": roofline_pct(
                   ps, "attn.flash", work, "attn_flops", peaks,
                   "bf16_ops_per_s")}
    else:
        got = {"program_idle.decode": idle_pct(ps, "serve.decode"),
               "launches_per_step.decode": ops_per_call(ps, "serve.decode"),
               "moe_experts_ms.decode": ms_per(ps, ("moe.experts",), work,
                                               "steps"),
               "moe_overhead_ms.decode": ms_per(ps, MOE_OVERHEAD, work,
                                                "steps"),
               "span_decode_attn_roofline.decode": roofline_pct(
                   ps, "attn.decode", work, "attn_bytes", peaks,
                   "hbm_bytes_per_s")}
    return {k: v for k, v in got.items() if v is not None}
