"""Uniform model API of the port: dispatch by ``cfg.family``.

    param_specs(cfg)                        → TensorSpecs of the JAX tree
    init_params(cfg, generator, device)     → a Transformer (random)
    forward_hidden(cfg, params, batch)      → (hidden, aux_loss)
    forward_train(cfg, params, batch)       → (logits, aux_loss)
    apply_unembed(cfg, params, hidden)      → logits, padded vocab masked
    forward_decode(cfg, params, batch, cache, pos) → (logits, cache)
    decode_state_specs(cfg, batch, max_len) → TensorSpecs of the cache
    init_decode_state(cfg, params, batch, max_len) → zeroed cache
    input_specs(cfg, shape)                 → TensorSpecs of a batch

The dense family runs; the other families (moe, vlm, ssm, hybrid, audio)
raise ``NotImplementedError`` until they are ported (ROADMAP.md,
queue 1).  ``SHAPES`` names the four assigned input shapes, as in the
JAX package.  The forward passes record gradients where the parameters
require them; serving callers run them under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses

import torch

from . import transformer
from .config import ModelConfig
from .transformer import TensorSpec

_PORTED_FAMILIES = ("dense",)


def _mod(cfg: ModelConfig):
    if cfg.family in _PORTED_FAMILIES:
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet "
        f"(ROADMAP.md, queue 1)")


def param_specs(cfg: ModelConfig) -> dict:
    return _mod(cfg).param_specs(cfg)


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
