"""Uniform model API of the port: dispatch by ``cfg.family``.

    init_params(cfg, generator, device)     → a Transformer (random)
    forward_hidden(cfg, params, batch)      → (hidden, aux_loss)
    forward_train(cfg, params, batch)       → (logits, aux_loss)
    apply_unembed(cfg, params, hidden)      → logits, padded vocab masked
    forward_decode(cfg, params, batch, cache, pos) → (logits, cache)
    decode_state_specs(cfg, batch, max_len) → TensorSpecs of the cache
    init_decode_state(cfg, params, batch, max_len) → zeroed cache

The dense family runs; the other families (moe, vlm, ssm, hybrid, audio)
raise ``NotImplementedError`` until they are ported (ROADMAP.md,
queue 1).  ``SHAPES`` names the four assigned input shapes, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from . import transformer
from .config import ModelConfig

_PORTED_FAMILIES = ("dense",)


def _mod(cfg: ModelConfig):
    if cfg.family in _PORTED_FAMILIES:
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet "
        f"(ROADMAP.md, queue 1)")


def init_params(cfg: ModelConfig, generator=0, device=None):
    return _mod(cfg).init_params(cfg, generator, device)


def forward_train(cfg, params, batch):
    return _mod(cfg).forward_train(cfg, params, batch)


def forward_hidden(cfg, params, batch):
    """Final-normed hidden states before the unembedding — the prefill
    path unembeds the last position only."""
    return _mod(cfg).forward_hidden(cfg, params, batch)


@torch.no_grad()
def apply_unembed(cfg: ModelConfig, params, hidden: torch.Tensor):
    logits = hidden @ params.unembed
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab:      # mask padded columns
        logits[..., cfg.vocab:] = -1e30
    return logits


def forward_decode(cfg, params, batch, cache, pos):
    return _mod(cfg).forward_decode(cfg, params, batch, cache, pos)


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return _mod(cfg).cache_specs(cfg, batch, max_len)


def init_decode_state(cfg: ModelConfig, params, batch: int,
                      max_len: int) -> dict:
    """A zeroed cache on the parameters' device."""
    return _mod(cfg).init_cache(cfg, batch, max_len, params.device)


# ---------------------------------------------------------------------------
# assigned input shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# long-context decode requires O(1)/sub-quadratic state
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_supported(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True
