"""Device milliseconds a decode step spends inside the harness's range
around ``models.transformer.moe_ffn`` (router, dispatch, expert products,
scatter), summed over the layers."""
from benchlib import readers


def read(r):
    return readers.range_ms_per(r, "moe_ffn", "steps")
