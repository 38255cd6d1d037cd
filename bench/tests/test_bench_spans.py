"""The reduction of the program's own spans (``benchlib.spans``) on made-up
traces, and the probe that reads them (``bench/probes/spans.py``) through
one traced run of a tiny cell on the CPU."""
import importlib.util

import pytest

from benchlib import spans as S
from benchlib.trace import PREFIX, WINDOW, Event, reduce_events
from conftest import BENCH, tiny_cell

P = S.PROGRAM


def ev(name, start, end, device=False, thread=1, corr=0, linked=0):
    return Event(name=name, device=device, start=start, end=end,
                 thread=thread, correlation=corr, linked=linked)


def harness_events():
    """A window with a harness range, launches tied to kernels, an untied
    kernel and idle gaps at 450-600 and 700-800 (the shape of
    ``test_bench_trace.test_reduce``)."""
    return [
        ev(WINDOW, 0, 1000),
        ev(PREFIX + "moe_ffn", 100, 330),
        ev("cudaLaunchKernel", 110, 120, corr=7),
        ev("cudaLaunchKernel", 300, 310, corr=8),
        ev("aten::mm", 290, 320),
        ev("aten::item", 400, 900),
        ev("kernel", 150, 300, device=True, linked=7),
        ev("untied_kernel", 300, 350, device=True),
        ev("gemm", 350, 450, device=True, linked=8),
        ev("cudaLaunchKernel", 650, 660, corr=9),
        ev("gemm", 600, 700, device=True, linked=9),
        ev("cudaLaunchKernel", 790, 795, corr=10),
        ev("late_gemm", 800, 900, device=True, linked=10),
    ]


def program_spans():
    """The program's spans over those events: a step over the launches
    of 7 and 8 with a nested span over both, and its idle half inside a
    second step.  Operator-scope ranges: host events only, each with its
    own correlation id (as the profiler gives every operator one)."""
    return [ev(P + "serve.decode", 50, 525, corr=101),
            ev(P + "moe.experts", 105, 315, corr=102),
            ev(P + "moe.dispatch", 280, 315, corr=103),
            ev(P + "serve.decode", 640, 750, corr=104)]


def test_program_spans_leave_every_summary_field_but_gap_names():
    """Given the same events, the harness's summary reads the same with
    the program's operator-scope spans among them; only the idle gaps
    may now be named by a span."""
    without = reduce_events(harness_events())
    with_spans = reduce_events(harness_events() + program_spans())
    for field in ("window_s", "busy_s", "range_device_s", "range_calls",
                  "device_ops"):
        assert getattr(with_spans, field) == getattr(without, field)
    # the gap at 700 began inside the second step, after aten::item began
    assert dict(with_spans.idle_gaps) == {"aten::item": 150 / 1e9,
                                          P + "serve.decode": 100 / 1e9}
    assert dict(without.idle_gaps) == {"aten::item": 250 / 1e9}


def ctypes_launch(span_start=None):
    """A harness range around a call that launches one kernel through an
    aten op and one (``K``) outside any: the profiler ties ``K`` to no
    host call, or to the innermost span open around its launch."""
    events = [ev(WINDOW, 0, 1000), ev(PREFIX + "decode_attn", 200, 400),
              ev("aten::mul", 100, 110, corr=7),
              ev("A", 150, 250, device=True, linked=7),
              ev("aten::copy_", 250, 260, corr=8),
              ev("B", 300, 320, device=True, linked=8),
              ev("aten::mm", 500, 510, corr=9),
              ev("C", 460, 500, device=True, linked=9)]
    if span_start is None:
        return events + [ev("K", 330, 450, device=True)]
    return events + [ev(P + "attn.decode", span_start, 600 - span_start,
                        corr=20),
                     ev("K", 330, 450, device=True, linked=20)]


def test_a_span_around_an_untied_launch_must_open_inside_the_range():
    """The span that ties ``K`` opens inside the harness's range, so the
    range reads what it read with ``K`` untied; one opened around the
    range would place ``K`` before it and leave the range no time (why
    ``attn.decode`` opens inside ``decode_attention``)."""
    def reading(events):
        return reduce_events(events).range_device_s["decode_attn"]
    assert reading(ctypes_launch()) == 140 / 1e9
    assert reading(ctypes_launch(span_start=210)) == 140 / 1e9
    assert reading(ctypes_launch(span_start=190)) == 0.0
    inside = S.reduce_spans(ctypes_launch(span_start=210))
    assert inside.spans["attn.decode"].device_s == 140 / 1e9


def test_device_side_copies_of_program_spans_are_no_operations():
    copies = [ev(P + "serve.decode", 150, 900, device=True)]
    ps = S.reduce_spans(harness_events() + program_spans() + copies)
    assert ps.spans == S.reduce_spans(harness_events()
                                      + program_spans()).spans


def test_reduce_spans():
    ps = S.reduce_spans(harness_events() + program_spans())
    assert ps.window_s == 1000 / 1e9
    got = {n: (s.calls, s.device_ops, s.device_s, s.idle_s)
           for n, s in ps.spans.items()}
    # the first step holds the kernels of 7 and 8 and the untied one
    # between them, the second the gemm of 9; the first step's span covers
    # the gap 450-600 to 525, the second's the gap 700-800 to 750
    assert got["serve.decode"] == (2, 4, 400 / 1e9, 125 / 1e9)
    # nested spans each count what they hold: the dispatch span holds the
    # launch of 8, so the operations from the end of 7's kernel up to 9's
    assert got["moe.experts"] == (1, 3, 300 / 1e9, 0.0)
    assert got["moe.dispatch"] == (1, 2, 150 / 1e9, 0.0)


def test_a_gap_half_inside_a_step_counts_half():
    events = [ev(WINDOW, 0, 1000), ev("k", 0, 400, device=True),
              ev("k", 600, 1000, device=True),
              ev(P + "serve.decode", 500, 900)]
    assert S.reduce_spans(events).spans["serve.decode"].idle_s == 100 / 1e9


def test_idle_counts_the_window_thread_only():
    events = [ev(WINDOW, 0, 1000), ev("k", 0, 400, device=True),
              ev("k", 600, 1000, device=True),
              ev(P + "serve.decode", 300, 700, thread=2)]
    assert S.reduce_spans(events).spans["serve.decode"].idle_s == 0.0


@pytest.mark.parametrize("a,b,want", [
    ([(0, 10)], [(0, 10)], 10), ([(0, 10)], [(5, 20)], 5),
    ([(0, 10), (20, 30)], [(5, 25)], 10),
    ([(0, 10), (20, 30)], [(5, 8), (6, 9), (22, 40)], 12),
    ([(0, 10)], [], 0), ([], [(0, 10)], 0)])
def test_overlap(a, b, want):
    assert S._overlap(a, b) == want


def test_no_window_or_no_device_op_gives_none():
    assert S.reduce_spans([ev(P + "serve.decode", 0, 10)]) is None
    assert S.reduce_spans([ev(WINDOW, 0, 10),
                           ev(P + "serve.decode", 0, 10)]) is None


PEAKS = {"bf16_ops_per_s": 1e3, "hbm_bytes_per_s": 1e2}


def test_quantities():
    ps = S.ProgramSpans(window_s=2.0, spans={
        "serve.decode": S.SpanStats(4, 1.0, 1200, 0.5),
        "moe.experts": S.SpanStats(16, 0.4, 48, 0.0),
        "moe.route": S.SpanStats(16, 0.02, 64, 0.0),
        "moe.aux_loss": S.SpanStats(16, 0.03, 80, 0.0),
        "attn.decode": S.SpanStats(16, 0.1, 64, 0.0)})
    work = {"steps": 4, "attn_bytes": 5.0}
    got = S.quantities(ps, work, PEAKS, "decode")
    assert got == pytest.approx({
        "program_idle.decode": 25.0, "launches_per_step.decode": 300.0,
        "moe_experts_ms.decode": 100.0, "moe_overhead_ms.decode": 12.5,
        "span_decode_attn_roofline.decode": 50.0})
    ps = S.ProgramSpans(window_s=2.0, spans={
        "serve.prefill": S.SpanStats(3, 1.5, 900, 0.2),
        "attn.flash": S.SpanStats(120, 0.5, 120, 0.0)})
    got = S.quantities(ps, {"attn_flops": 250.0}, PEAKS, "prefill")
    assert got == pytest.approx({"program_idle.prefill": 10.0,
                                 "span_flash_roofline.prefill": 50.0})


def test_quantities_leave_out_what_is_missing():
    assert S.quantities(None, {"steps": 4}, PEAKS, "decode") == {}
    ps = S.ProgramSpans(window_s=2.0, spans={
        "serve.decode": S.SpanStats(4, 1.0, 1200, 0.0),
        "attn.decode": S.SpanStats(16, 0.0, 0, 0.0)})
    got = S.quantities(ps, {"steps": 4, "attn_bytes": 5.0}, None, "decode")
    # idle 0 is a reading; no MoE span, no attention device time, no peaks
    assert got == {"program_idle.decode": 0.0,
                   "launches_per_step.decode": 300.0}


def load_probe():
    spec = importlib.util.spec_from_file_location(
        "bench_probe_spans", BENCH / "probes" / "spans.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_runs_a_traced_cell_and_restores_the_harness():
    from benchlib import manifest, runner, trace
    before = (trace.kineto_events, manifest.load_driver, runner.per_layer)
    out = load_probe().probe(tiny_cell("grok-1.decode"), 79, 0.3,
                             device="cpu")
    assert (trace.kineto_events, manifest.load_driver,
            runner.per_layer) == before
    assert out["correct"] is True
    assert out["traced_end_to_end"]["decode_tokens_per_s"] > 0
    assert out["trace_timing"]["events"] > 0
    # a CPU trace holds no device operation: nothing to read
    assert out["spans"] is None and out["span_metrics"] == {}
