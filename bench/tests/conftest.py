"""Tests of the benchmark (``bench/``), run on the CPU at tiny sizes:

    PYTHONPATH=src python -m pytest -q bench/tests

The test marked ``cuda`` runs one short cell on a card and skips
elsewhere."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import manifest  # noqa: E402

#: each driver's configuration at a size the CPU runs in seconds, deep
#: enough that the float8 control's error stands above the committed limits
TINY = {
    "prefill": dict(hidden_size=256, intermediate_size=512,
                    num_hidden_layers=12, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=64, vocab_size=2048),
    "decode": dict(hidden_size=128, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=32, vocab_size=512),
}
TINY_PARAMS = {
    "prefill": dict(min_len=16, max_len=128, lengths=6, cycles=4,
                    check_requests=3),
    "decode": dict(batch=64, context=64, max_len=96, chunk=16,
                   check_positions=4, margin_floor=0.02),
}


def tiny_cell(name: str, **config) -> manifest.Cell:
    """The manifest's cell ``name`` with its configuration at tiny widths
    (every other key, the limits among them, as committed)."""
    cell = manifest.load_cell(name)
    cfg = dict(cell.config, **TINY[cell.driver])
    cfg.update(config)
    cell.config = cfg
    cell.workload = dict(cell.workload,
                         params=dict(TINY_PARAMS[cell.driver]))
    return cell


@pytest.fixture
def cells():
    return [w["name"] for w in manifest.load_manifest()["workloads"]]
