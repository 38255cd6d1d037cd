"""The decode-attention call's share of the HBM peak: the live K/V and the
queries read and the float32 result written, over the device time inside the
harness's range around ``models.transformer.decode_attention`` (the folding
copies and the kernel), in %."""
from benchlib import readers


def read(r):
    return readers.range_bytes_pct(r, "decode_attn", "attn_bytes")
