"""Model FLOP utilisation of prefill: the model operations of every request
completed in the traced window (matmuls and causal attention,
``benchlib.flops.prefill_flops``) over the window at the card's bf16 peak,
in %."""
from benchlib import readers


def read(r):
    return readers.model_flops_pct(r, "model_flops")
