"""The plain reference agrees with the program on tiny versions of both
configurations, through the harness's own window and comparison."""
import pytest
import torch

from benchlib import runner
from benchlib.shape import Shape
from conftest import tiny_cell
from reference import transformer as R


@pytest.mark.parametrize("name", ["qwen3-14b.prefill", "grok-1.decode"])
def test_float32_agrees(name):
    """In float32 the program and the reference differ by rounding."""
    cell = tiny_cell(name, dtype="float32")
    _, numbers, _ = runner.run_cell(cell, 2**31 + 5, 0.3, False,
                                    device="cpu")
    for n in numbers:
        if n.name == "near_tie_share":      # a share left out, no error
            assert n.value < 1.0, n
            continue
        assert n.value == 0.0 if "gap" in n.name else n.value < 1e-3, n


@pytest.mark.parametrize("name", ["qwen3-14b.prefill", "grok-1.decode"])
def test_bfloat16_within_limits(name):
    """At the seed the fault tests use, the unbroken run is correct."""
    cell = tiny_cell(name)
    result, numbers, _ = runner.run_cell(cell, 3141592653, 1.0, False,
                                         device="cpu")
    assert result["correct"], numbers


def test_routing_groups_and_capacity():
    assert R.routing_groups(64) == 1
    assert R.routing_groups(16384) == 64
    assert R.routing_groups(1000) == 2      # 3 does not divide 1000
    s = Shape.from_config(tiny_cell("grok-1.decode").config)
    assert R.capacity(64, s.scaled(experts=8)) == 20
    assert R.capacity(8, s.scaled(experts=4)) == 5


def test_capacity_drops_follow_arrival_order():
    """Two tokens routed to one expert with capacity for one: the first
    keeps its share, the second gets nothing from that expert."""
    s = Shape(name="t", family="moe", layers=1, d=4, heads=1, kv_heads=1,
              hd=4, ff=4, vocab=8, experts=2, top_k=1,
              capacity_factor=0.0)
    torch.manual_seed(0)
    x = torch.randn(6, 4)
    w = {"router": torch.zeros(4, 2), "we_gate": torch.randn(2, 4, 4),
         "we_up": torch.randn(2, 4, 4), "we_down": torch.randn(2, 4, 4)}
    w["router"][:, 0] = 100.0             # every token prefers expert 0
    x = x.abs() + 0.1
    group = torch.zeros(6, dtype=torch.long)
    out = R.moe(s, x, w, (group, [6]), R.Precision("fp32"))
    # capacity max(int(0), 4) = 4: the first four tokens kept
    assert (out[:4].abs().sum(-1) > 0).all()
    assert (out[4:] == 0).all()
