"""Decoder-only transformer of the port: the dense, MoE and VLM families.

The JAX package's ``repro.models.transformer`` holds its parameters as a
pytree with the blocks stacked on a leading layer axis and scans over
them.  Here a :class:`Transformer` module holds the same leaves under the
same names (``embed``, ``unembed``, ``final_norm`` and, per block,
``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``qnorm``, ``knorm``,
and ``w_gate``, ``w_up``, ``w_down`` or, for MoE, ``router``,
``we_gate``, ``we_up``, ``we_down`` and the shared expert's ``ws_gate``,
``ws_up``, ``ws_down``), one block per layer in an ``nn.ModuleList``
(``repro_torch.models.params``), and the forward passes loop over them.
Weights are stored ``(in, out)`` and applied as ``x @ w``, attention
tensors are ``(B, H, S, D)`` and caches ``(L, B, Hkv, Smax, hd)``, as in
the JAX package.  Prefill and training attention is the flash-attention
kernel, decode attention the decode-attention kernel (their plain
versions on the CPU).  The MoE FFN is ``layers.moe_ffn`` and its
load-balancing loss is averaged over the layers; a VLM batch's
``patch_embeds`` replace the token embeddings at ``patch_positions``.

Parameters are created frozen (``requires_grad`` false), so the serving
paths, which also run under ``torch.no_grad()``, build no autograd graph;
a trainer calls ``model.requires_grad_()`` on its own model.  With
``cfg.remat`` and gradients recorded, each block runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as the JAX
package's ``jax.checkpoint`` around its scan body.

Decode applies each layer's sliding window and the attention softcap
inside the decode kernel, as the JAX package's ``decode_attention_jnp``
does (gemma2).  Not ported yet (ROADMAP.md, queue 1): decode of more than
one new token per step.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._cuda import resolve_device
from repro_torch.kernels.decode_attention import decode_attention

from . import params as P
from .config import ModelConfig
from .layers import (aux_load_balance_loss, blocked_attention, moe_ffn,
                     rms_norm, rope, rope_tables, swiglu)
from .params import TensorSpec

_ROADMAP = "not ported yet (ROADMAP.md, queue 1)"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def block_shapes(cfg: ModelConfig) -> dict:
    """Per-layer parameter shapes of one block (without the layer axis)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    shapes = {"ln1": (d,), "ln2": (d,), "wq": (d, Hq * hd),
              "wk": (d, Hkv * hd), "wv": (d, Hkv * hd), "wo": (Hq * hd, d)}
    if cfg.qk_norm:
        shapes["qnorm"] = (hd,)
        shapes["knorm"] = (hd,)
    if cfg.n_experts:
        E = cfg.n_experts
        shapes.update({"router": (d, E), "we_gate": (E, d, ff),
                       "we_up": (E, d, ff), "we_down": (E, ff, d)})
        if cfg.shared_expert:
            shapes.update({"ws_gate": (d, ff), "ws_up": (d, ff),
                           "ws_down": (ff, d)})
    else:
        shapes.update({"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)})
    return shapes


def top_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"embed": (cfg.padded_vocab, d), "unembed": (d, cfg.padded_vocab),
            "final_norm": (d,)}


def layout(cfg: ModelConfig) -> dict:
    """The JAX package's tree: the top leaves and ``blocks``."""
    return {**top_shapes(cfg), "blocks": P.Stack(cfg.n_layers,
                                                 block_shapes(cfg))}


def param_specs(cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree as :class:`TensorSpec` leaves:
    ``embed``, ``unembed``, ``final_norm`` and ``blocks`` with every block
    leaf stacked on a leading layer axis."""
    return P.specs(layout(cfg), cfg.torch_dtype)


class Transformer(P.ParamTree):
    """The parameters of a decoder-only transformer, frozen until
    ``requires_grad_()``.  Use :func:`init_params` or
    ``repro_torch.models.convert.params_from_numpy`` to fill them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(layout(cfg), resolve_device(device),
                         cfg.torch_dtype)


empty_params = Transformer


def _init_rule(name: str, tree_shape: tuple):
    """The JAX package's init (``transformer.py:65-81``): normal ·
    1/sqrt(shape[-2]) for 2-D and up (a block leaf with its layer axis,
    so a block's (L, hd) ``qnorm`` draws at 1/sqrt(L)), else 0.02; the
    norms ``final_norm``, ``ln1`` and ``ln2`` at zero (``rms_norm``
    applies ``1 + scale``)."""
    if name in ("final_norm", "ln1", "ln2"):
        return torch.zeros
    return (P.fan_in(tree_shape, "mul") if len(tree_shape) >= 2
            else P.times(0.02))


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> Transformer:
    """Random parameters drawn on ``device`` (the card unless named) at
    the JAX package's scales (:func:`_init_rule`): an ``int`` seed draws
    ``jax.random``'s numbers for ``PRNGKey(seed)``, a
    ``torch.Generator`` its own (:func:`params.init_`)."""
    return P.init_(Transformer(cfg, device), generator, _init_rule)


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------
def _attention(cfg: ModelConfig, p, x: torch.Tensor, tables, *,
               window, cache=None, pos=None) -> torch.Tensor:
    """x (B, S, d) → (B, S, d); ``cache`` is this layer's (k, v, kv_len):
    (B, Hkv, Smax, hd) views into the model's cache, written in place, and
    the (B,) int32 lengths after this step."""
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p.wq).view(B, S, Hq, hd)
    k = (x @ p.wk).view(B, S, Hkv, hd)
    v = (x @ p.wv).view(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.qnorm)
        k = rms_norm(k, p.knorm)
    q = rope(q, tables)
    k = rope(k, tables)
    if cache is None:
        # the kernel writes (B, Hq, S, hd) through a (B, S, Hq, hd) buffer's
        # strides, so the reshape below needs no copy
        out = blocked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True, window=window,
                                softcap=cfg.attn_softcap)
        out = out.transpose(1, 2).reshape(B, S, Hq * hd)
    else:
        ck, cv, kv_len = cache
        # in place: the JAX package's dynamic_update_slice returns a new
        # cache instead
        ck[:, :, pos:pos + S] = k.transpose(1, 2)
        cv[:, :, pos:pos + S] = v.transpose(1, 2)
        o = decode_attention(q[:, 0], ck, cv, kv_len, window=window,
                             softcap=cfg.attn_softcap)[0]   # (B, Hq, hd)
        out = o.reshape(B, S, Hq * hd)
    return out.to(x.dtype) @ p.wo


def _ffn(cfg: ModelConfig, p, x: torch.Tensor):
    """Dense or MoE FFN on (B, S, d) → (out, aux loss)."""
    B, S, d = x.shape
    if not cfg.n_experts:
        return swiglu(x, p.w_gate, p.w_up, p.w_down), 0.0
    flat = x.reshape(B * S, d)
    y = moe_ffn(flat, p.router, p.we_gate, p.we_up, p.we_down,
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    aux = aux_load_balance_loss(flat, p.router, cfg.top_k)
    if cfg.shared_expert:
        y = y + swiglu(flat, p.ws_gate, p.ws_up, p.ws_down)
    return y.reshape(B, S, d), aux


def _block(cfg: ModelConfig, p, x: torch.Tensor, tables, *, window,
           cache=None, pos=None):
    """One layer → (x, its aux loss)."""
    x = x + _attention(cfg, p, rms_norm(x, p.ln1), tables, window=window,
                       cache=cache, pos=pos)
    out, aux = _ffn(cfg, p, rms_norm(x, p.ln2))
    return x + out, aux


def window_for(cfg: ModelConfig, layer: int):
    """Per-layer window: gemma2 alternates local (even) and global."""
    if cfg.layer_pattern == "local_global":
        return cfg.sliding_window if layer % 2 == 0 else None
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def embed_tokens(model, tokens) -> torch.Tensor:
    """The rows of ``model.embed`` of ``tokens`` (any integer type, on
    any device)."""
    tokens = torch.as_tensor(tokens, device=model.device)
    return model.embed[tokens.long()]


def _embed(cfg: ModelConfig, model: Transformer, batch: dict) -> torch.Tensor:
    x = embed_tokens(model, batch["tokens"])
    if cfg.family == "vlm" and "patch_embeds" in batch:
        # the stub vision frontend's embeddings over the image-slot tokens
        pe = torch.as_tensor(batch["patch_embeds"], device=x.device)
        pp = torch.as_tensor(batch["patch_positions"],
                             device=x.device).long()          # (B, P)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        x = x.index_put((rows.expand_as(pp), pp), pe.to(x.dtype))
    return x


def forward_hidden(cfg: ModelConfig, model: Transformer, batch: dict):
    """→ (final-normed hidden (B, S, d), aux loss) — pre-unembed; the aux
    loss is the MoE load-balancing loss averaged over the layers (0.0
    for a dense model).  Differentiable; with ``cfg.remat`` and gradients
    recorded each block is recomputed in the backward."""
    x = _embed(cfg, model, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    tables = rope_tables(positions, cfg.hd, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for layer, blk in enumerate(model.blocks):
        window = window_for(cfg, layer)
        if remat:
            x, a = checkpoint(_block, cfg, blk, x, tables, window=window,
                              use_reentrant=False)
        else:
            x, a = _block(cfg, blk, x, tables, window=window)
        aux = aux + a
    return rms_norm(x, model.final_norm), aux / cfg.n_layers


def unembed(cfg: ModelConfig, model: Transformer,
            hidden: torch.Tensor) -> torch.Tensor:
    logits = hidden @ model.unembed
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap)
    return logits


def forward_train(cfg: ModelConfig, model: Transformer, batch: dict):
    """→ (logits (B, S, V), aux loss)."""
    hidden, aux = forward_hidden(cfg, model, batch)
    return unembed(cfg, model, hidden), aux


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    kv = TensorSpec((cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd),
                    cfg.torch_dtype)
    return {"k": kv, "v": kv}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    device = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in cache_specs(cfg, batch, max_len).items()}


def check_decode_supported(n_new: int, pos: int, smax: int | None) -> int:
    """Raise for what the port's decode does not take: more than one new
    token a step (the JAX package's decode attention has no causal mask
    among new tokens), or a position past a cache of ``smax`` positions
    (the JAX package's dynamic_update_slice would clamp it) → ``pos`` as
    an int."""
    if n_new != 1:
        raise NotImplementedError(
            f"decode of {n_new} new tokens at once is {_ROADMAP}: the JAX "
            f"package's decode attention has no causal mask among new "
            f"tokens")
    pos = int(pos)
    if smax is not None and not 0 <= pos <= smax - n_new:
        raise ValueError(f"decode position {pos} outside a cache of "
                         f"{smax} positions")
    return pos


@torch.no_grad()
def forward_decode(cfg: ModelConfig, model: Transformer, batch: dict,
                   cache: dict, pos: int):
    """One decode step.  batch["tokens"] (B, 1); cache {"k", "v"} (L, B,
    Hkv, Smax, hd), updated in place; pos: the current length, shared by
    every row.  → (logits (B, 1, V), the same cache).  A position past
    the cache raises (the JAX package's dynamic_update_slice would clamp
    it)."""
    x = _embed(cfg, model, batch)
    B, S, _ = x.shape
    pos = check_decode_supported(S, pos, cache["k"].shape[3])
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    tables = rope_tables(positions, cfg.hd, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    kv_len = torch.full((B,), pos + S, dtype=torch.int32, device=x.device)
    for layer, blk in enumerate(model.blocks):
        x, _ = _block(cfg, blk, x, tables, window=window_for(cfg, layer),
                      cache=(ck[layer], cv[layer], kv_len), pos=pos)
    x = rms_norm(x, model.final_norm)
    return unembed(cfg, model, x), cache
