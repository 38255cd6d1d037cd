"""Whisper-style encoder-decoder backbone (arXiv:2212.04356): the port's
copy of the JAX package's ``repro.models.whisper``.

Backbone only: the conv audio frontend is a STUB — callers feed
precomputed frame embeddings (B, n_frames, d) straight into the encoder
(bidirectional self-attention: the flash kernel, non-causal); the decoder
is a causal LM (self-attention through the flash kernel in prefill, the
decode kernel over its cache in decode) with cross-attention into the
encoder's keys and values (the flash kernel, non-causal, at Sq = 1 in
decode; the decoder may be longer than the encoder, which the kernel
takes when non-causal).  Decode carries the self-attention cache, written
in place, and the precomputed encoder K/V.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._cuda import resolve_device
from repro_torch.kernels.decode_attention import decode_attention

from . import params as P
from . import transformer
from .config import ModelConfig
from .layers import blocked_attention, rms_norm, swiglu
from .params import TensorSpec

POS_DEC = 4096                         # decoder positions


def enc_block_shapes(cfg: ModelConfig) -> dict:
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.hd
    H = cfg.n_heads
    return {"ln1": (d,), "ln2": (d,),
            "wq": (d, H * hd), "wk": (d, H * hd), "wv": (d, H * hd),
            "wo": (H * hd, d),
            "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}


def dec_block_shapes(cfg: ModelConfig) -> dict:
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    return {**enc_block_shapes(cfg), "ln_x": (d,),
            "xq": (d, H * hd), "xk": (d, H * hd), "xv": (d, H * hd),
            "xo": (H * hd, d)}


def layout(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "embed": (cfg.padded_vocab, d),
        "unembed": (d, cfg.padded_vocab),
        "pos_dec": (POS_DEC, d),
        "pos_enc": (max(cfg.n_frames, 1), d),
        "final_norm": (d,),
        "enc_blocks": P.Stack(cfg.encoder_layers, enc_block_shapes(cfg)),
        "dec_blocks": P.Stack(cfg.n_layers, dec_block_shapes(cfg)),
        "enc_final_norm": (d,),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return P.specs(layout(cfg), cfg.torch_dtype)


def empty_params(cfg: ModelConfig, device=None) -> P.ParamTree:
    """The family's parameter tree on ``device`` (the card unless named),
    frozen and unfilled."""
    return P.ParamTree(layout(cfg), resolve_device(device), cfg.torch_dtype)


def _init_rule(name: str, tree_shape: tuple):
    """The JAX package's per-name init (``whisper.py:61-77``)."""
    if name.startswith(("ln", "final", "enc_final")):
        return torch.zeros
    if name.startswith("pos"):
        return P.times(0.02)
    return P.fan_in(tree_shape, "div")


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> P.ParamTree:
    return P.init_(empty_params(cfg, device), generator, _init_rule)


def _heads(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """(B, S, H·hd) → (B, H, S, hd), a view."""
    B, S, _ = t.shape
    return t.view(B, S, cfg.n_heads, cfg.hd).transpose(1, 2)


def _merge(out: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, S, hd) → (B, S, H·hd) in ``dtype``."""
    B, H, S, hd = out.shape
    return out.transpose(1, 2).reshape(B, S, H * hd).to(dtype)


def _self_attn(cfg: ModelConfig, p, x, *, causal: bool, cache=None,
               pos=None):
    """x (B, S, d) → (B, S, d); ``cache`` is this layer's (k, v, kv_len),
    written in place at ``pos``."""
    q, k, v = (_heads(cfg, x @ w) for w in (p.wq, p.wk, p.wv))
    if cache is None:
        out = blocked_attention(q, k, v, causal=causal)
    else:
        ck, cv, kv_len = cache
        S = x.shape[1]
        ck[:, :, pos:pos + S] = k
        cv[:, :, pos:pos + S] = v
        out = decode_attention(q[:, :, 0], ck, cv, kv_len)[0][:, :, None]
    return _merge(out, x.dtype) @ p.wo


def _cross_attn(cfg: ModelConfig, p, x, enc_k, enc_v):
    """enc_k/enc_v (B, H, F, hd) precomputed from the encoder output;
    every query sees every frame."""
    q = _heads(cfg, x @ p.xq)
    out = blocked_attention(q, enc_k, enc_v, causal=False)
    return _merge(out, x.dtype) @ p.xo


def _enc_block(cfg: ModelConfig, p, x):
    x = x + _self_attn(cfg, p, rms_norm(x, p.ln1), causal=False)
    return x + swiglu(rms_norm(x, p.ln2), p.w_gate, p.w_up, p.w_down)


def encode(cfg: ModelConfig, model: P.ParamTree, frames) -> torch.Tensor:
    """frames (B, F, d) — the stub frontend's output → encoder output."""
    frames = torch.as_tensor(frames, device=model.device)
    x = frames.to(cfg.torch_dtype) + model.pos_enc[None, :frames.shape[1]]
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.enc_blocks:
        if remat:
            x = checkpoint(_enc_block, cfg, blk, x, use_reentrant=False)
        else:
            x = _enc_block(cfg, blk, x)
    return rms_norm(x, model.enc_final_norm)


def _enc_kv(cfg: ModelConfig, model: P.ParamTree, enc_out):
    """Cross-attention K/V per decoder layer, each stacked on L:
    (L, B, H, F, hd) twice."""
    ks = [_heads(cfg, enc_out @ blk.xk) for blk in model.dec_blocks]
    vs = [_heads(cfg, enc_out @ blk.xv) for blk in model.dec_blocks]
    return torch.stack(ks), torch.stack(vs)


def _dec_block(cfg: ModelConfig, p, x, ek, ev, cache=None, pos=None):
    x = x + _self_attn(cfg, p, rms_norm(x, p.ln1), causal=True, cache=cache,
                       pos=pos)
    x = x + _cross_attn(cfg, p, rms_norm(x, p.ln_x), ek, ev)
    return x + swiglu(rms_norm(x, p.ln2), p.w_gate, p.w_up, p.w_down)


def _decoder(cfg: ModelConfig, model: P.ParamTree, tokens, enc_kv, pos,
             cache=None):
    x = transformer.embed_tokens(model, tokens)
    B, S, _ = x.shape
    start = 0 if pos is None else pos
    x = x + model.pos_dec[start:start + S][None]
    ek, ev = enc_kv
    remat = cache is None and cfg.remat and torch.is_grad_enabled()
    if cache is not None:
        kv_len = torch.full((B,), pos + S, dtype=torch.int32,
                            device=x.device)
    for layer, blk in enumerate(model.dec_blocks):
        if cache is not None:
            c = (cache["k"][layer], cache["v"][layer], kv_len)
            x = _dec_block(cfg, blk, x, ek[layer], ev[layer], c, pos)
        elif remat:
            x = checkpoint(_dec_block, cfg, blk, x, ek[layer], ev[layer],
                           use_reentrant=False)
        else:
            x = _dec_block(cfg, blk, x, ek[layer], ev[layer])
    return rms_norm(x, model.final_norm)


def forward_hidden(cfg: ModelConfig, model: P.ParamTree, batch: dict):
    """batch: frames (B, F, d) + tokens (B, S) → (hidden, aux 0.0)."""
    enc = encode(cfg, model, batch["frames"])
    hidden = _decoder(cfg, model, batch["tokens"],
                      _enc_kv(cfg, model, enc), pos=None)
    return hidden, 0.0


def forward_train(cfg: ModelConfig, model: P.ParamTree, batch: dict):
    hidden, aux = forward_hidden(cfg, model, batch)
    return hidden @ model.unembed, aux


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    H, hd, L = cfg.n_heads, cfg.hd, cfg.n_layers
    kv = TensorSpec((L, batch, H, max_len, hd), cfg.torch_dtype)
    ekv = TensorSpec((L, batch, H, cfg.n_frames, hd), cfg.torch_dtype)
    return {"k": kv, "v": kv, "enc_k": ekv, "enc_v": ekv}


@torch.no_grad()
def init_cache(cfg: ModelConfig, model: P.ParamTree, frames, batch: int,
               max_len: int) -> dict:
    """Encode ``frames`` once → the decode cache: zeroed self-attention
    K/V and the encoder's K/V for every decoder layer."""
    ek, ev = _enc_kv(cfg, model, encode(cfg, model, frames))
    shape = (cfg.n_layers, batch, cfg.n_heads, max_len, cfg.hd)
    kw = dict(dtype=cfg.torch_dtype, device=model.device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "enc_k": ek, "enc_v": ev}


@torch.no_grad()
def forward_decode(cfg: ModelConfig, model: P.ParamTree, batch: dict,
                   cache: dict, pos: int):
    """One token at ``pos`` → (logits (B, 1, V), the cache, its
    self-attention K/V written in place)."""
    tokens = torch.as_tensor(batch["tokens"])
    pos = transformer.check_decode_supported(tokens.shape[1], pos,
                                             cache["k"].shape[3])
    hidden = _decoder(cfg, model, tokens, (cache["enc_k"], cache["enc_v"]),
                      pos, cache=cache)
    return hidden @ model.unembed, cache
