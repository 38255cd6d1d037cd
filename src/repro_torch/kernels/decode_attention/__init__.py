"""Decode attention (a step's new tokens against a KV cache) for the port: the
Hopper kernel, its plain version and the ``cuda → plain`` dispatch.
Returns the partial-softmax triple so sequence shards can be combined."""
from .kernel import decode_attention_cuda
from .ops import combine_partials, decode_attention, decode_attention_folded
from .ref import combine_partials_ref, decode_attention_ref

__all__ = ["combine_partials", "combine_partials_ref", "decode_attention",
           "decode_attention_cuda", "decode_attention_folded",
           "decode_attention_ref"]
