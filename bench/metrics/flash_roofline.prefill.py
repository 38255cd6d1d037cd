"""The attention call's share of the bf16 peak: live causal pairs at 4 x
head_dim operations a query head, over the device time inside the harness's
range around ``models.transformer.blocked_attention`` (the flash kernel and
whatever else the call launches), in %."""
from benchlib import readers


def read(r):
    return readers.range_ops_pct(r, "flash", "attn_flops")
