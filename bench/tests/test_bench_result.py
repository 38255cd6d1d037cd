"""The result line's shape."""
import json

import pytest

from benchlib import runner
from conftest import tiny_cell


@pytest.mark.parametrize("name", ["qwen3-14b.prefill", "grok-1.decode"])
def test_last_line_shape(name):
    cell = tiny_cell(name)
    result, numbers, _ = runner.run_cell(cell, 77, 0.3, False, device="cpu")
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"               # the compared numbers last
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {n.name for n in numbers}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_holds_per_layer_only():
    cell = tiny_cell("grok-1.decode")
    result, _, _ = runner.run_cell(cell, 78, 0.3, True, device="cpu")
    names = {m["name"] for m in cell.per_layer}
    assert set(result["metrics"]) <= names    # a CPU trace reads no card
