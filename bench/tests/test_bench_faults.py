"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have, and so does the control (the
reference in float8 in the program's place).  The harness's look for a
card is skipped: these run on the CPU at tiny sizes with the committed
limits."""
import pytest
import torch

from benchlib import check, manifest, runner
from conftest import tiny_cell

SEED = 3141592653


def _run(name, control=False):
    return runner.run_cell(tiny_cell(name), SEED, 1.0, False, device="cpu",
                           control=control)


def _altered(fn):
    """The served token altered where it is produced: the logits rolled
    by one along the vocabulary."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, tuple):
            return (torch.roll(out[0], 1, dims=-1),) + tuple(out[1:])
        return torch.roll(out, 1, dims=-1)
    return wrapped


@pytest.mark.parametrize("name", ["qwen3-14b.prefill", "grok-1.decode"])
def test_control_fails(name):
    result, numbers, control = _run(name, control=True)
    assert result["correct"]
    assert not check.verdict(control), control


def test_prefill_token_altered(monkeypatch):
    from repro_torch.models import api
    monkeypatch.setattr(api, "apply_unembed", _altered(api.apply_unembed))
    result, numbers, _ = _run("qwen3-14b.prefill")
    assert not result["correct"], numbers


def test_decode_token_altered(monkeypatch):
    from repro_torch.models import api
    monkeypatch.setattr(api, "forward_decode", _altered(api.forward_decode))
    result, numbers, _ = _run("grok-1.decode")
    assert not result["correct"], numbers


def test_decode_one_sequence_altered(monkeypatch):
    """One sequence of the batch's 64 decoded wrong at every step: too few
    tokens to move the 90th percentiles, caught by the widest over the
    tokens whose routing clears the margin floor."""
    from repro_torch.models import api
    real = api.forward_decode

    def one_row(*a, **k):
        logits, cache = real(*a, **k)
        logits = logits.clone()
        logits[0] = torch.roll(logits[0], 1, dims=-1)
        return logits, cache
    monkeypatch.setattr(api, "forward_decode", one_row)
    result, numbers, _ = _run("grok-1.decode")
    failed = {n.name for n in numbers if not n.ok}
    assert not result["correct"], numbers
    assert failed >= {"greedy_gap_clear_max", "logit_err_clear_max"}, numbers
    assert not failed & {"greedy_gap_p90", "logit_err_p90"}, numbers


def test_decode_judges_the_wrap():
    """The judged steps cover the first lap's first and last, the first
    step after the wrap, and others across the lap."""
    decode = manifest.load_driver("decode")
    p = dict(tiny_cell("grok-1.decode").params)
    lap = p["max_len"] - p["context"]
    steps = decode.judged_steps(p, SEED)
    assert {0, lap - 1, lap} <= steps
    assert len(steps) == 3 + p["check_positions"]
    assert max(steps) == lap


def test_decode_state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the cache is never
    written past set-up."""
    from repro_torch.models import api
    real = api.forward_decode
    calls = {"n": 0}

    def frozen(cfg, params, batch, cache, pos):
        calls["n"] += 1
        if batch["tokens"].shape[1] > 1:          # set-up's context chunks
            return real(cfg, params, batch, cache, pos)
        scratch = {k: v.clone() for k, v in cache.items()}
        logits, _ = real(cfg, params, batch, scratch, pos)
        return logits, cache
    monkeypatch.setattr(api, "forward_decode", frozen)
    result, numbers, _ = _run("grok-1.decode")
    assert calls["n"] > 0
    assert not result["correct"], numbers
