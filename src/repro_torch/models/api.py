"""Uniform model API of the port: dispatch by ``cfg.family``, as the JAX
package's ``repro.models.api``: ``dense``, ``moe`` and ``vlm`` run the
transformer, ``ssm`` RWKV6, ``hybrid`` the Zamba2 hybrid and ``audio``
whisper.

    param_specs(cfg)                        → TensorSpecs of the JAX tree
    empty_params(cfg, device)               → the family's model, unfilled
    init_params(cfg, generator, device)     → the family's model (random)
    forward_hidden(cfg, params, batch)      → (hidden, aux_loss)
    forward_train(cfg, params, batch)       → (logits, aux_loss)
    apply_unembed(cfg, params, hidden)      → logits, padded vocab masked
    forward_decode(cfg, params, batch, state, pos) → (logits, state)
    decode_state_specs(cfg, batch, max_len) → TensorSpecs of the state
    init_decode_state(cfg, params, batch, max_len, frames=None) → state
    input_specs(cfg, shape)                 → TensorSpecs of a batch

``SHAPES`` names the four assigned input shapes, as in the JAX package.
The forward passes record gradients where the parameters require them;
serving callers run them under ``torch.no_grad()``.  Decode takes several
new tokens a step in the transformer families and whisper, as the JAX
package does; RWKV6 and Zamba2 take one (their non-chunked scans).
"""
from __future__ import annotations

import dataclasses

import torch

from . import rwkv, ssm, transformer, whisper
from .config import ModelConfig
from .params import TensorSpec

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def _mod(cfg: ModelConfig):
    if cfg.family in _TRANSFORMER_FAMILIES:
        return transformer
    if cfg.family == "ssm":
        return rwkv
    if cfg.family == "hybrid":
        return ssm
    if cfg.family == "audio":
        return whisper
    raise ValueError(f"unknown model family {cfg.family!r}")


def param_specs(cfg: ModelConfig) -> dict:
    return _mod(cfg).param_specs(cfg)


def empty_params(cfg: ModelConfig, device=None):
    """The family's parameter module on ``device`` (the card unless
    named), its values unset."""
    return _mod(cfg).empty_params(cfg, device)


def init_params(cfg: ModelConfig, generator=0, device=None):
    return _mod(cfg).init_params(cfg, generator, device)


def forward_train(cfg, params, batch):
    return _mod(cfg).forward_train(cfg, params, batch)


def forward_hidden(cfg, params, batch):
    """Final-normed hidden states before the unembedding — the prefill
    path unembeds the last position only."""
    return _mod(cfg).forward_hidden(cfg, params, batch)


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
    if cfg.family in _TRANSFORMER_FAMILIES:
        return transformer.cache_specs(cfg, batch, max_len)
    if cfg.family == "ssm":
        return rwkv.state_specs(cfg, batch)
    if cfg.family == "hybrid":
        return ssm.state_specs(cfg, batch, max_len)
    if cfg.family == "audio":
        return whisper.cache_specs(cfg, batch, max_len)
    raise ValueError(f"unknown model family {cfg.family!r}")


def init_decode_state(cfg: ModelConfig, params, batch: int, max_len: int,
                      frames=None) -> dict:
    """The decode state on the parameters' device: zeroed, and for audio
    the encoder's K/V of ``frames`` (zero frames by default)."""
    if cfg.family == "audio":
        if frames is None:
            frames = torch.zeros((batch, cfg.n_frames, cfg.d_model),
                                 dtype=cfg.torch_dtype, device=params.device)
        return whisper.init_cache(cfg, params, frames, batch, max_len)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=params.device)
            for name, s in decode_state_specs(cfg, batch, max_len).items()}


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


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """:class:`TensorSpec` stand-ins for every model input of a shape
    cell, as the JAX package's ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len

    def tok(s):
        return TensorSpec((B, s), torch.int32)

    if shape.kind == "train":
        batch = {"tokens": tok(S), "labels": tok(S)}
    elif shape.kind == "prefill":
        batch = {"tokens": tok(S)}
    else:  # decode: one new token; cache of length S is a separate input
        batch = {"tokens": tok(1)}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["patch_embeds"] = TensorSpec((B, cfg.n_patches, cfg.d_model),
                                           cfg.torch_dtype)
        batch["patch_positions"] = TensorSpec((B, cfg.n_patches),
                                              torch.int32)
    if cfg.family == "audio" and shape.kind != "decode":
        batch["frames"] = TensorSpec((B, cfg.n_frames, cfg.d_model),
                                     cfg.torch_dtype)
    return batch
