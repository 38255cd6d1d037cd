"""The traced run: the harness's own ranges around calls into the
program's layers, the profiler over the measured window, and the
reduction of its device trace to the numbers the per-layer readers take.

With ``--trace 1`` a :class:`Tracer` replaces a few functions the program
imported into its modules (``models.transformer``'s ``blocked_attention``,
``moe_ffn`` and ``decode_attention``, ``train.train_step``'s
``adamw_update``) by wrappers that open a ``torch.profiler``
``record_function`` range named ``bench/<layer>`` around each call.  A
range's device time is the sum of the device operations launched from
inside it: the trace's correlation ids tie kernels to the host calls that
launched them, and stream order places the rest (:func:`_range_device_s`).
Busy time is the union of the device operations' intervals within the
window; the idle gaps are named by the host operation running on the
window's thread when the gap began.  With ``--trace 0`` nothing is
replaced and no profiler runs."""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict

PREFIX = "bench/"
WINDOW = PREFIX + "window"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    range_device_s: dict          # range name → device seconds
    range_calls: dict             # range name → host entries
    device_ops: list              # [(name, seconds)], the 10 largest
    idle_gaps: list               # [(host activity, seconds)], 10 largest


class Tracer:
    """Ranges around the program's calls, and the profiler over the
    window; inert unless ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self._patched = []
        self.prof = None
        self.timing = {}      # what reading the trace cost, for the log

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)

    def wrap(self, module, attr: str, name: str) -> None:
        """Open the range ``name`` around every call of ``module.attr``
        made through the module (the program's own imported name)."""
        if not self.enabled:
            return
        fn = getattr(module, attr)
        tracer = self

        def wrapped(*args, **kwargs):
            with tracer.range(name):
                return fn(*args, **kwargs)

        setattr(module, attr, wrapped)
        self._patched.append((module, attr, fn))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._patched):
            setattr(module, attr, fn)
        self._patched.clear()

    @contextlib.contextmanager
    def window(self):
        """The measured window: under the profiler when enabled."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        with torch.profiler.record_function(WINDOW):
            yield
        t0 = time.perf_counter()
        prof.stop()
        self.timing["stop_s"] = time.perf_counter() - t0
        self.prof = prof

    def summary(self) -> Summary | None:
        if self.prof is None:
            return None
        t0 = time.perf_counter()
        events = kineto_events(self.prof)
        t1 = time.perf_counter()
        out = reduce_events(events)
        self.timing.update(events=len(events), read_s=t1 - t0,
                           reduce_s=time.perf_counter() - t1)
        return out


@dataclasses.dataclass(slots=True)
class Event:
    name: str
    device: bool                  # runs on the card
    start: int                    # ns
    end: int
    thread: int = 0               # host events
    correlation: int = 0          # a host API call's id
    linked: int = 0               # a device op's host call id


def kineto_events(prof) -> list:
    """The profiler's raw events as :class:`Event` (no Python tree),
    reading from each only what the reduction uses."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            out.append(Event(e.name(), True, start, end,
                             linked=e.linked_correlation_id()))
        else:
            out.append(Event(e.name(), False, start, end,
                             e.start_thread_id(), e.correlation_id()))
    return out


def _union(intervals) -> tuple:
    """Total length of the union of ``(start, end)`` intervals, and the
    gaps between them → (busy, [(gap start, gap end)])."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


class _Spans:
    """Non-overlapping spans of one name on one thread, for lookups by
    time."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.ends[i] >= t


def reduce_events(events: list) -> Summary | None:
    """The trace's numbers over the window range, or None where the trace
    holds no window range or no device operation in it."""
    windows = [e for e in events if e.name == WINDOW and not e.device]
    if not windows:
        return None
    win = max(windows, key=lambda e: e.end - e.start)
    w0, w1 = win.start, win.end
    # a device-side copy of a range ("bench/...") is no operation
    ops = [e for e in events if e.device and not e.name.startswith(PREFIX)
           and e.end > w0 and e.start < w1]
    if not ops:
        return None
    busy, gaps = _union((max(e.start, w0), min(e.end, w1)) for e in ops)
    host = [e for e in events if not e.device]
    ranges = defaultdict(lambda: defaultdict(list))      # name → thread
    for e in host:
        if e.name.startswith(PREFIX) and e.name != WINDOW:
            ranges[e.name[len(PREFIX):]][e.thread].append((e.start, e.end))
    spans = {n: {t: _Spans(v) for t, v in by.items()}
             for n, by in ranges.items()}
    calls = {n: sum(len(v) for v in by.values())
             for n, by in ranges.items()}
    per_op = defaultdict(float)
    for op in ops:
        per_op[op.name] += (op.end - op.start) / 1e9
    dev_s = _range_device_s(ranges, host, ops)
    idle = _name_gaps(gaps, host, win.thread)
    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        range_device_s=dict(dev_s), range_calls=calls,
        device_ops=sorted(per_op.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:10])


def _range_device_s(ranges, host, ops) -> dict:
    """Device seconds of each range.  The operations one stream runs keep
    their launch order, so the operations launched inside a host range
    are those that start after the last operation launched before the
    range ended and before the first one launched after it.  Launches the
    trace ties to a host call fix those edges; operations it does not tie
    (a kernel launched through a library's own runtime) fall between
    them and count too."""
    launch = {e.correlation: e.start for e in host if e.correlation}
    tied = sorted((launch[op.linked], op.start, op.end) for op in ops
                  if op.linked in launch)
    if not tied:
        return {}
    at = [t for t, _, _ in tied]
    by_start = sorted((op.start, op.end - op.start) for op in ops)
    starts = [s for s, _ in by_start]
    total = [0]
    for _, d in by_start:
        total.append(total[-1] + d)
    out = {}
    for name, by_thread in ranges.items():
        t = 0
        for spans in by_thread.values():
            for h0, h1 in spans:
                i = bisect.bisect_left(at, h0) - 1
                d0 = tied[i][2] if i >= 0 else starts[0]
                j = bisect.bisect_right(at, h1)
                d1 = tied[j][1] if j < len(tied) else starts[-1] + 1
                lo = bisect.bisect_left(starts, d0)
                hi = bisect.bisect_left(starts, d1)
                t += total[max(hi, lo)] - total[lo]
        out[name] = t / 1e9
    return out


def _name_gaps(gaps, host, thread) -> dict:
    """Idle time by the innermost host operation on the window's thread
    when each gap began."""
    mine = sorted((e.start, -e.end, e.name) for e in host
                  if e.thread == thread and e.name != WINDOW
                  and not e.name.startswith("cuda") and e.end > e.start)
    starts = [s for s, _, _ in mine]
    out = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        name = "host (no operation)"
        # the latest-starting operation still running at g0 is innermost
        for j in range(i, max(i - 256, -1), -1):
            if -mine[j][1] >= g0:
                name = mine[j][2]
                break
        out[name] += (g1 - g0) / 1e9
    return out
