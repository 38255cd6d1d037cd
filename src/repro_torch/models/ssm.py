"""Mamba2 blocks + the Zamba2 hybrid (arXiv:2411.15242): the port's copy of
the JAX package's ``repro.models.ssm``.

Mamba2 block: in-proj → (z, x, B, C, dt); causal conv over (x, B, C); the
SSD recurrence S_t = exp(a·dt_t)·S_{t−1} + dt_t·B_tᵀx_t, y_t = C_t·S_t run
through the shared chunked linear scan (inclusive, one decay a head); a
gated RMS-norm output.  Its arithmetic is float32, as in the JAX package.

Zamba2: a stack of Mamba2 blocks with ONE weight-shared attention + MLP
block applied after every ``attn_every`` of them, each application with
its own KV cache.  The shared block is the transformer's dense block
(``transformer._block``: the same leaves, RoPE, causal attention through
the flash kernel in prefill and the decode kernel in decode).

Decode returns a new state as the JAX package does: the per-layer SSM
and conv states are new tensors (the conv state in float32 after the first
step, as there), and the shared block's KV cache is written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._cuda import resolve_device

from . import params as P
from . import prng
from . import transformer
from .config import ModelConfig
from .layers import rms_norm, rope_tables
from .linear_scan import (check_one_token, chunked_linear_scan,
                          linear_scan_decode)
from .params import TensorSpec

EXPAND = 2
HEAD = 64                              # mamba2 head dim


def _dims(cfg: ModelConfig):
    d_in = EXPAND * cfg.d_model
    H = d_in // HEAD
    N = cfg.ssm_state
    return d_in, H, N


def mamba_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, H, N = _dims(cfg)
    conv_ch = d_in + 2 * N
    return {
        "ln": (d,),
        "w_in": (d, 2 * d_in + 2 * N + H),    # z, x, B, C, dt
        "conv_w": (cfg.conv_width, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": (H,), "dt_bias": (H,), "D": (H,),
        "gn_scale": (d_in,),
        "w_out": (d_in, d),
    }


def shared_block_shapes(cfg: ModelConfig) -> dict:
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, Hq * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd),
        "wo": (Hq * hd, d),
        "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d),
    }


def layout(cfg: ModelConfig) -> dict:
    return {**transformer.top_shapes(cfg),
            "blocks": P.Stack(cfg.n_layers, mamba_block_shapes(cfg)),
            "shared": shared_block_shapes(cfg)}


def mamba_block_specs(cfg: ModelConfig, L: int) -> dict:
    """The JAX package's tree of ``L`` stacked Mamba2 blocks: each leaf a
    :class:`TensorSpec` with the layer axis first."""
    return P.specs({"blocks": P.Stack(L, mamba_block_shapes(cfg))},
                   cfg.torch_dtype)["blocks"]


def shared_block_specs(cfg: ModelConfig) -> dict:
    """The JAX package's tree of the one shared attention block."""
    return P.specs(shared_block_shapes(cfg), cfg.torch_dtype)


def param_specs(cfg: ModelConfig) -> dict:
    return P.specs(layout(cfg), cfg.torch_dtype)


def empty_params(cfg: ModelConfig, device=None) -> P.ParamTree:
    """The family's parameter tree on ``device`` (the card unless named),
    frozen and unfilled."""
    return P.ParamTree(layout(cfg), resolve_device(device), cfg.torch_dtype)


def _init_rule(name: str, tree_shape: tuple):
    """The JAX package's per-name init (``ssm.py:135-158``)."""
    if name in ("ln", "ln1", "ln2", "final_norm", "gn_scale", "conv_b"):
        return torch.zeros
    if name == "A_log":
        return lambda shape: prng.xla_log(
            prng.linspace(0.5, 4.0, shape[-1])).expand(shape)
    if name == "dt_bias":
        return lambda shape: torch.full(shape, -2.0)
    if name == "D":
        return torch.ones
    return P.fan_in(tree_shape, "div")


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> P.ParamTree:
    return P.init_(empty_params(cfg, device), generator, _init_rule)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, H, N = _dims(cfg)
    return torch.split(proj, [d_in, d_in, N, N, H], dim=-1)


def _causal_conv(x, w, b, conv_state=None):
    """x (B, T, C); depthwise causal conv of width K.  ``conv_state``
    (B, K−1, C) carries the last K−1 inputs for decode → (silu(out + b),
    the new state)."""
    K = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i][None, None] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(out + b[None, None]), new_state


def mamba_forward(cfg: ModelConfig, p, x, ssm_state, conv_state, *,
                  chunked: bool = True):
    """x (B, T, d) → (x + out, new ssm state, new conv state)."""
    B, T, d = x.shape
    d_in, H, N = _dims(cfg)
    proj = rms_norm(x, p.ln).float() @ p.w_in.float()
    z, xc, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p.conv_w.float(),
                                      p.conv_b.float(), conv_state)
    xc, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)
    dt = F.softplus(dt + p.dt_bias.float()[None, None])     # (B, T, H)
    a = -torch.exp(p.A_log.float())                         # (H,)
    logw = (a[None, None] * dt)[..., None]                  # (B, T, H, 1)
    v = xc.reshape(B, T, H, HEAD) * dt[..., None]           # (B, T, H, 64)
    q = Cm[:, :, None, :].expand(B, T, H, N)
    k = Bm[:, :, None, :].expand(B, T, H, N)
    if chunked:
        y, new_ssm = chunked_linear_scan(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            logw.transpose(1, 2), ssm_state, inclusive=True)
    else:
        y, new_ssm = linear_scan_decode(q[:, 0], k[:, 0], v[:, 0],
                                        logw[:, 0], ssm_state, inclusive=True)
        y = y[:, :, None, :]
    y = y.transpose(1, 2).reshape(B, T, d_in)
    y = y + xc * p.D.float().repeat_interleave(HEAD)[:d_in]
    # gated RMS norm (mamba2)
    y = y * F.silu(z)
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * (1 + p.gn_scale.float())
    out = (y @ p.w_out.float()).to(x.dtype)
    return x + out, new_ssm, new_conv


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------
def _segments(cfg: ModelConfig):
    """Static segmentation: shared block after every attn_every mamba
    blocks → [(start, end)], the shared block between segments."""
    k = cfg.attn_every or cfg.n_layers + 1
    bounds = list(range(0, cfg.n_layers, k))[1:]
    segs, prev = [], 0
    for b in bounds:
        segs.append((prev, b))
        prev = b
    segs.append((prev, cfg.n_layers))
    return segs


def n_shared_applications(cfg: ModelConfig) -> int:
    return len(_segments(cfg)) - 1


def state_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    d_in, H, N = _dims(cfg)
    L = cfg.n_layers
    kv = TensorSpec((n_shared_applications(cfg), batch, cfg.n_kv_heads,
                     max_len, cfg.hd), cfg.torch_dtype)
    return {
        "ssm": TensorSpec((L, batch, H, N, HEAD), torch.float32),
        "conv": TensorSpec((L, batch, cfg.conv_width - 1, d_in + 2 * N),
                           cfg.torch_dtype),
        "k": kv, "v": kv,
    }


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    device = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in state_specs(cfg, batch, max_len).items()}


def _run(cfg: ModelConfig, model: P.ParamTree, tokens, state, pos, *,
         chunked: bool):
    """The stack → (final-normed hidden, per-layer new ssm and conv
    states).  Prefill (``chunked``, no ``state``) starts every layer from
    zeros and runs the shared block's attention through the flash
    kernel; decode reads ``state`` and writes the shared block's caches
    in place."""
    x = transformer.embed_tokens(model, tokens)
    B, S, _ = x.shape
    positions = ((0 if pos is None else pos)
                 + torch.arange(S, device=x.device)).expand(B, S)
    tables = rope_tables(positions, cfg.hd, cfg.rope_theta)
    d_in, H, N = _dims(cfg)
    remat = cfg.remat and chunked and torch.is_grad_enabled()
    segs = _segments(cfg)
    new_ssm, new_conv = [], []
    if not chunked:
        kv_len = torch.full((B,), pos + S, dtype=torch.int32,
                            device=x.device)
    for i, (a, b) in enumerate(segs):
        for layer in range(a, b):
            blk = model.blocks[layer]
            if chunked:
                s0 = x.new_zeros((B, H, N, HEAD), dtype=torch.float32)
                c0 = None
            else:
                s0, c0 = state["ssm"][layer], state["conv"][layer]
            if remat:
                x, ns, nc = checkpoint(mamba_forward, cfg, blk, x, s0, c0,
                                       chunked=chunked, use_reentrant=False)
            else:
                x, ns, nc = mamba_forward(cfg, blk, x, s0, c0,
                                          chunked=chunked)
            new_ssm.append(ns)
            new_conv.append(nc)
        if i < len(segs) - 1:
            cache = None if chunked else (state["k"][i], state["v"][i],
                                          kv_len)
            x, _ = transformer._block(cfg, model.shared, x, tables,
                                      window=None, cache=cache, pos=pos)
    return rms_norm(x, model.final_norm), new_ssm, new_conv


def forward_hidden(cfg: ModelConfig, model: P.ParamTree, batch: dict):
    """→ (final-normed hidden (B, S, d), aux loss 0.0)."""
    hidden, _, _ = _run(cfg, model, batch["tokens"], None, None,
                        chunked=True)
    return hidden, 0.0


def forward_train(cfg: ModelConfig, model: P.ParamTree, batch: dict):
    hidden, aux = forward_hidden(cfg, model, batch)
    return hidden @ model.unembed, aux


@torch.no_grad()
def forward_decode(cfg: ModelConfig, model: P.ParamTree, batch: dict,
                   state: dict, pos: int):
    """One token against ``state`` (:func:`state_specs`) at position
    ``pos`` → (logits (B, 1, V), the new state: new ``ssm`` and ``conv``
    tensors, the ``k``/``v`` caches written in place)."""
    tokens = torch.as_tensor(batch["tokens"])
    check_one_token(tokens.shape[1])
    pos = transformer.check_decode_position(tokens.shape[1], pos,
                                            state["k"].shape[3])
    hidden, ssm, conv = _run(cfg, model, tokens, state, pos, chunked=False)
    new_state = {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
                 "k": state["k"], "v": state["v"]}
    return hidden @ model.unembed, new_state
