"""The operations and bytes of each measured call, from its shapes alone.

These are the benchmark's yardstick: a later change to the program may
replace a kernel, but the work a call asks for stays what these functions
say.  A matmul parameter costs 2 operations a token forward (6 with the
backward); a live (query, key) pair costs ``4 · head_dim`` operations a
query head (scores and the value product) forward.  Bytes count each input
read once and each output written once."""
from __future__ import annotations

from .shape import Shape


def causal_pairs(S: int) -> int:
    """Live (query, key) pairs of a causal self-attention over ``S``."""
    return S * (S + 1) // 2


def attn_flops(s: Shape, pairs: int) -> int:
    """Forward attention operations of one layer over ``pairs`` live pairs
    of every query head."""
    return 4 * s.hd * s.heads * pairs


def prefill_flops(s: Shape, S: int) -> int:
    """Model operations of a prefill of one ``S``-token prompt: every
    layer's matmuls and causal attention, and the unembedding of the last
    position."""
    return s.layers * (2 * s.layer_matmul_params() * S
                       + attn_flops(s, causal_pairs(S))) \
        + 2 * s.d * s.vocab


def decode_step_flops(s: Shape, B: int, kv_len: int) -> int:
    """Operations of one decode step: ``B`` new tokens, each through the
    active matmuls of every layer and the unembedding, attending to
    ``kv_len`` keys."""
    return B * (s.layers * 2 * s.layer_matmul_params(active=True)
                + 2 * s.d * s.vocab) \
        + s.layers * attn_flops(s, B * kv_len)


def kv_bytes(s: Shape, B: int, kv_len: int, itemsize: int = 2) -> int:
    """K and V of ``kv_len`` positions of ``B`` rows, one layer."""
    return 2 * B * s.kv_heads * kv_len * s.hd * itemsize


def decode_step_bytes(s: Shape, B: int, kv_len: int,
                      itemsize: int = 2) -> int:
    """Bytes one decode step has to move at least: every weight of every
    layer once (each expert, as a batch routes to all of them), the
    unembedding, the ``B`` embedding rows and the live K/V."""
    weights = s.layers * s.layer_matmul_params(active=False) \
        + s.d * s.vocab + B * s.d
    return weights * itemsize + s.layers * kv_bytes(s, B, kv_len, itemsize)


def decode_attn_bytes(s: Shape, B: int, kv_len: int, itemsize: int = 2,
                      n_new: int = 1) -> int:
    """One layer's decode attention: the live K/V and the queries read,
    the float32 result with its row max and sum written."""
    q = B * s.heads * n_new * s.hd * itemsize
    out = B * s.heads * n_new * (s.hd + 2) * 4
    return kv_bytes(s, B, kv_len, itemsize) + q + out


def train_model_flops(s: Shape, B: int, S: int) -> int:
    """Model operations of a training step on a (B, S) batch: 6 a matmul
    parameter a token (the embedding is a gather), and attention's live
    causal pairs at 4·head_dim forward, three times over with the
    backward."""
    n_mm = s.layers * s.layer_matmul_params() + s.d * s.vocab
    pairs = B * s.heads * causal_pairs(S)
    return 6 * n_mm * B * S + 3 * 4 * s.hd * pairs * s.layers


def roofline_s(nbytes: int, ops: int, ops_per_s: float,
               bytes_per_s: float) -> tuple:
    """The least time a call could take → (seconds, "bytes" or
    "operations", whichever bounds it)."""
    b, o = nbytes / bytes_per_s, ops / ops_per_s
    return max(b, o), ("bytes" if b >= o else "operations")
