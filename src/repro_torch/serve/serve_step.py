"""Serving steps of the port: prefill (full-sequence forward, last-position
logits) and decode (one token against the KV cache / recurrent state), as
in the JAX package's ``repro.serve.serve_step``, for every family.  Both run under ``torch.no_grad()``:
serving builds no autograd graph, whatever the parameters require."""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.spans import span


def make_prefill_step(cfg):
    """prefill(params, batch) → last-position logits (B, V).

    Unembeds only the final position — full-sequence logits at 32k would
    be hundreds of GB and no server needs them.
    """

    @torch.no_grad()
    def prefill(params, batch):
        with span("serve.prefill"):
            hidden, _ = api.forward_hidden(cfg, params, batch)
            return api.apply_unembed(cfg, params, hidden[:, -1, :])

    return prefill


def make_decode_step(cfg):
    """decode(params, batch, state, pos) → (next-token logits (B, V),
    state); a KV cache is updated in place, a recurrent state may come
    back as new tensors (``api.forward_decode``)."""

    @torch.no_grad()
    def decode(params, batch, state, pos):
        with span("serve.decode"):
            logits, new_state = api.forward_decode(cfg, params, batch,
                                                   state, pos)
            logits = logits[:, -1, :]
            if cfg.padded_vocab != cfg.vocab:   # mask padded vocab columns
                logits[:, cfg.vocab:] = -1e30
            return logits, new_state

    return decode


def greedy_generate(cfg, params, prompt_tokens, n_steps: int, max_len: int,
                    frames=None):
    """Simple greedy decoding loop (examples/tests); prompt (B, S0) →
    (B, n_steps) tokens.  The prompt is fed one token at a time; an audio
    model encodes ``frames`` (zero frames by default) first."""
    prompt = torch.as_tensor(prompt_tokens, device=params.device)
    B, S0 = prompt.shape
    state = api.init_decode_state(cfg, params, B, max_len, frames=frames)
    decode = make_decode_step(cfg)
    logits = None
    for t in range(S0):
        logits, state = decode(params, {"tokens": prompt[:, t:t + 1]},
                               state, t)
    out = [logits.argmax(-1)]
    for t in range(S0, S0 + n_steps - 1):
        logits, state = decode(params, {"tokens": out[-1][:, None]}, state, t)
        out.append(logits.argmax(-1))
    return torch.stack(out, dim=1)
