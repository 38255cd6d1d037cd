"""The port's spans (``repro_torch.spans``) in its serving steps, attention
and MoE layer, on the CPU under ``torch.profiler``: free and inert with no
profiler, the expected names and counts under one, each inside its step's
span on the step's thread, operator-scope ranges (which the profiler does
not copy onto a device's stream), the logits unchanged, and the meta-device
dry run unchanged.  Both a tiny MoE (grok-1's SMOKE) and a tiny dense model
(qwen3's SMOKE)."""
import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, trace_analysis
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import api
from repro_torch.serve import serve_step

ARCHS = ("grok1_314b", "qwen3_14b")
KINDS = ("prefill", "decode")
B, S, MAX_LEN = 2, 16, 32
#: the spans inside a step, a layer: attention, and the MoE layer's five
ATTN = {"prefill": "attn.flash", "decode": "attn.decode"}
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
       "moe.aux_loss")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param, smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(4))
    return cfg, params, tokens


def run_step(model, kind):
    """One prefill call of the whole prompt, or one decode step after a
    prefilled cache (a fresh state each call) → logits."""
    cfg, params, tokens = model
    if kind == "prefill":
        return serve_step.make_prefill_step(cfg)(params, {"tokens": tokens})
    decode = serve_step.make_decode_step(cfg)
    state = api.init_decode_state(cfg, params, B, MAX_LEN)
    _, state = decode(params, {"tokens": tokens[:, :-1]}, state, 0)
    return decode(params, {"tokens": tokens[:, -1:]}, state, S - 1)[0]


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(spans.PREFIX)]


def expected(cfg, kind) -> Counter:
    want = Counter({f"serve.{kind}": 1, ATTN[kind]: cfg.n_layers})
    if cfg.n_experts:
        want.update({name: cfg.n_layers for name in MOE})
    return want


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    got = {id(spans.span(name)) for name in ("serve.decode", "moe.route",
                                             "attn.flash")}
    assert got == {id(spans._OFF)}
    with spans.span("serve.decode") as inside:
        assert inside is None


@pytest.mark.parametrize("on", [False, True], ids=["off", "profiled"])
def test_decode_step_dispatches_no_profiler_op(model, on):
    """The aten ops a decode step dispatches hold no ``profiler::`` op:
    with no profiler a span is the null context, under one it is no
    operator (a user-scope ``record_function`` would dispatch
    ``profiler::_record_function_enter_new``)."""
    def traced():
        return trace_analysis.trace(run_step, model, "decode")[1]
    tr = profiled(traced)[0] if on else traced()
    names = [op.name for op in tr.ops]
    assert names and not [n for n in names if n.startswith("profiler")]


@pytest.mark.parametrize("kind", KINDS)
def test_one_call_emits_the_expected_spans(model, kind):
    cfg = model[0]
    _, events = profiled(lambda: run_step(model, kind))
    got = Counter(e.name()[len(spans.PREFIX):] for e in events)
    if kind == "decode":       # the step that filled the cache emits too
        got.subtract(expected(cfg, "decode"))
        got = +got
    assert got == expected(cfg, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_spans_lie_inside_their_step_span_on_its_thread(model, kind):
    _, events = profiled(lambda: run_step(model, kind))
    step = f"{spans.PREFIX}serve.{kind}"
    steps = [e for e in events if e.name() == step]
    assert steps
    for e in events:
        if e.name() == step:
            continue
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        assert any(s.start_thread_id() == e.start_thread_id()
                   and s.start_ns() <= t0
                   and t1 <= s.start_ns() + s.duration_ns()
                   for s in steps), e.name()


def test_spans_are_operator_scope_ranges(model, tmp_path):
    """A span is a ``cpu_op`` in the profiler's trace, not a
    ``user_annotation``, which the profiler copies onto a device's stream
    as a range over the kernels launched inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_step(model, "decode")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if str(e.get("name", "")).startswith(spans.PREFIX)}
    assert cats == {"cpu_op"}


@pytest.mark.parametrize("kind", KINDS)
def test_logits_are_bit_identical_with_the_profiler_on_and_off(model, kind):
    off = run_step(model, kind)
    on, events = profiled(lambda: run_step(model, kind))
    assert events and torch.equal(on, off)


@pytest.mark.parametrize("kind", KINDS)
def test_dry_run_is_unchanged_under_the_profiler(model, kind):
    """The meta-device dry run traces the same ops and numbers with the
    spans open as closed."""
    cfg = model[0]
    shape = api.InputShape(f"{kind}_s", 32, 8, kind)
    mesh = MeshShape((1, 1), ("data", "model"))
    off = dryrun.dry_run(cfg, shape, mesh)
    on, events = profiled(lambda: dryrun.dry_run(cfg, shape, mesh))
    assert Counter(e.name()[len(spans.PREFIX):] for e in events) \
        == expected(cfg, kind)
    for rec in (off, on):
        rec.pop("trace_s")
    assert on == off and off["status"] == "ok"
