"""RWKV6 "Finch" — attention-free LM with data-dependent decay
(arXiv:2404.05892): the port's copy of the JAX package's
``repro.models.rwkv``.

Time-mix: data-dependent token-shift lerp (ddlerp LoRAs) producing r, k,
v, g and the per-channel decay w_t = exp(−exp(w0 + LoRA_w(x̃))); the WKV
recurrence runs through the shared chunked linear scan (exclusive form
with bonus u).  Channel-mix: token-shifted squared-ReLU FFN.  No attention
kernel runs: the family has no attention.

O(1)-state decode: each layer carries (x_prev_att, x_prev_ffn, WKV
state); :func:`forward_decode` writes the new state into ``state`` in
place (each leaf keeps its type, so the values are the JAX package's new
state's).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._cuda import resolve_device

from . import params as P
from . import transformer
from .config import ModelConfig
from .layers import rms_norm
from .linear_scan import (check_one_token, chunked_linear_scan,
                          linear_scan_decode)
from .params import TensorSpec

LORA_R = 64


def block_shapes(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    H, N = cfg.n_wkv_heads, cfg.wkv_head_dim
    return {
        "ln1": (d,), "ln2": (d,),
        # ddlerp: base mus + one LoRA pair per stream (r, k, v, w, g)
        "mu_base": (5, d),
        "lora_a": (5, d, LORA_R), "lora_b": (5, LORA_R, d),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
        "wo": (d, d),
        "w0": (d,),                               # decay bias
        "wdecay_a": (d, LORA_R), "wdecay_b": (LORA_R, d),
        "bonus_u": (H, N),
        "gn_scale": (H, N),                       # per-head group norm
        # channel mix
        "mu_ck": (d,), "mu_cr": (d,),
        "ck": (d, ff), "cv": (ff, d), "cr": (d, d),
    }


def layout(cfg: ModelConfig) -> dict:
    return {**transformer.top_shapes(cfg),
            "blocks": P.Stack(cfg.n_layers, block_shapes(cfg))}


def param_specs(cfg: ModelConfig) -> dict:
    return P.specs(layout(cfg), cfg.torch_dtype)


def empty_params(cfg: ModelConfig, device=None) -> P.ParamTree:
    """The family's parameter tree on ``device`` (the card unless named),
    frozen and unfilled."""
    return P.ParamTree(layout(cfg), resolve_device(device), cfg.torch_dtype)


def _init_rule(name: str, tree_shape: tuple):
    """The JAX package's per-name init (``rwkv.py:51-70``)."""
    if name in ("ln1", "ln2", "final_norm", "w0", "gn_scale"):
        return torch.zeros
    if name.startswith("mu"):
        return lambda shape: torch.full(shape, 0.5)
    if name == "bonus_u":
        return lambda shape: torch.full(shape, 0.1)
    return P.fan_in(tree_shape, "div")


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> P.ParamTree:
    return P.init_(empty_params(cfg, device), generator, _init_rule)


def _token_shift(x, x_prev_first):
    """Shift the sequence right by one; position 0 sees x_prev_first
    (B, d)."""
    return torch.cat([x_prev_first[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(x, xs, mu_base, lora_a, lora_b):
    """Data-dependent lerp for the 5 streams → [r, k, v, w, g], each
    (B, T, d) float32.  The token-shift difference is taken in float32:
    the JAX package writes ``(xs - x).astype(f32)``, and XLA computes the
    bf16 difference with excess precision (it drops the bf16 rounding
    before the cast), so float32 is the number the reference gives."""
    delta = xs.float() - x.float()
    xf = x.float()
    # shared inner mix then per-stream LoRA (Finch §3)
    inner = xf + delta * mu_base[0][None, None]
    mixes = []
    for i in range(5):
        lor = torch.tanh(inner @ lora_a[i].float()) @ lora_b[i].float()
        mu = mu_base[i][None, None].float() + lor
        mixes.append(xf + delta * mu)
    return mixes


def _time_mix(cfg: ModelConfig, p, x, x_prev, wkv_state, *,
              chunked: bool = True):
    """x (B, T, d) → (out, new x_prev (B, d), new wkv state)."""
    B, T, d = x.shape
    H, N = cfg.n_wkv_heads, cfg.wkv_head_dim
    xs = _token_shift(x, x_prev)
    xr, xk, xv, xw, xg = _ddlerp(x, xs, p.mu_base, p.lora_a, p.lora_b)

    def heads(t):                      # (B, T, d) → (B, H, T, N)
        return t.reshape(B, T, H, N).transpose(1, 2)

    r = heads(xr @ p.wr.float())
    k = heads(xk @ p.wk.float())
    v = heads(xv @ p.wv.float())
    g = F.silu(xg @ p.wg.float())
    dec = p.w0.float()[None, None] + \
        torch.tanh(xw @ p.wdecay_a.float()) @ p.wdecay_b.float()
    logw = heads(-torch.exp(-3.0 + dec))   # w = exp(−exp(·)) ∈ (0, 1)
    u = p.bonus_u.float()
    if chunked:
        y, new_state = chunked_linear_scan(r, k, v, logw, wkv_state,
                                           inclusive=False, bonus=u)
    else:
        y, new_state = linear_scan_decode(
            r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], wkv_state,
            inclusive=False, bonus=u)
        y = y[:, :, None, :]
    # per-head group norm, then gate
    y = y.transpose(1, 2)                                # (B, T, H, N)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5) * \
        (1.0 + p.gn_scale.float())[None, None]
    y = y.reshape(B, T, d) * g
    out = (y @ p.wo.float()).to(x.dtype)
    return out, x[:, -1, :], new_state


def _channel_mix(p, x, x_prev):
    xs = _token_shift(x, x_prev)
    delta = xs.float() - x.float()         # as in _ddlerp
    xk = x.float() + delta * p.mu_ck.float()
    xr = x.float() + delta * p.mu_cr.float()
    h = torch.square(torch.relu(xk @ p.ck.float()))
    out = torch.sigmoid(xr @ p.cr.float()) * (h @ p.cv.float())
    return out.to(x.dtype), x[:, -1, :]


def _block(cfg: ModelConfig, p, x, x_att, x_ffn, wkv, chunked: bool):
    """One layer → (x, new x_att, new x_ffn, new wkv)."""
    att_out, xp_att, wkv = _time_mix(cfg, p, rms_norm(x, p.ln1), x_att, wkv,
                                     chunked=chunked)
    x = x + att_out
    ffn_out, xp_ffn = _channel_mix(p, rms_norm(x, p.ln2), x_ffn)
    return x + ffn_out, xp_att, xp_ffn, wkv


def state_specs(cfg: ModelConfig, batch: int) -> dict:
    H, N, d, L = cfg.n_wkv_heads, cfg.wkv_head_dim, cfg.d_model, cfg.n_layers
    return {
        "x_att": TensorSpec((L, batch, d), cfg.torch_dtype),
        "x_ffn": TensorSpec((L, batch, d), cfg.torch_dtype),
        "wkv": TensorSpec((L, batch, H, N, N), torch.float32),
    }


def init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    device = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in state_specs(cfg, batch).items()}


def forward_hidden(cfg: ModelConfig, model: P.ParamTree, batch: dict):
    """→ (final-normed hidden (B, S, d), aux loss 0.0), every layer from a
    zero state; with ``cfg.remat`` and gradients recorded each block is
    recomputed in the backward."""
    x = transformer.embed_tokens(model, batch["tokens"])
    B, _, d = x.shape
    H, N = cfg.n_wkv_heads, cfg.wkv_head_dim
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.blocks:
        zx = x.new_zeros((B, d))
        zs = x.new_zeros((B, H, N, N), dtype=torch.float32)
        if remat:
            x = checkpoint(_block, cfg, blk, x, zx, zx, zs, True,
                           use_reentrant=False)[0]
        else:
            x = _block(cfg, blk, x, zx, zx, zs, True)[0]
    return rms_norm(x, model.final_norm), 0.0


def forward_train(cfg: ModelConfig, model: P.ParamTree, batch: dict):
    hidden, aux = forward_hidden(cfg, model, batch)
    return hidden @ model.unembed, aux


@torch.no_grad()
def forward_decode(cfg: ModelConfig, model: P.ParamTree, batch: dict,
                   state: dict, pos: int):
    """One token; ``state`` carries per-layer (x_att, x_ffn, wkv) and is
    updated in place.  ``pos`` is unused (RWKV has no positional
    encoding) but kept for API symmetry.  → (logits (B, 1, V), state)."""
    x = transformer.embed_tokens(model, batch["tokens"])
    check_one_token(x.shape[1])
    for layer, blk in enumerate(model.blocks):
        x, xa, xf, wkv = _block(cfg, blk, x, state["x_att"][layer],
                                state["x_ffn"][layer], state["wkv"][layer],
                                False)
        state["x_att"][layer] = xa
        state["x_ffn"][layer] = xf
        state["wkv"][layer] = wkv
    x = rms_norm(x, model.final_norm)
    return x @ model.unembed, state
