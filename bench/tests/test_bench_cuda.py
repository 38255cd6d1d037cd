"""On a card: both drivers at tiny sizes through the program's kernels,
traced, judged by the reference (``-m cuda``; skips without a card)."""
import pytest

from benchlib import runner
from conftest import tiny_cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-14b.prefill", "grok-1.decode"])
def test_cell_on_the_card(card, name):
    result, numbers, control = runner.run_cell(
        tiny_cell(name), 2718281828, 2.0, True, device=card, control=True)
    assert result["correct"], numbers
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"]
    for m in result["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] < 105
