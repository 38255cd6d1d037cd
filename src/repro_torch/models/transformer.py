"""Decoder-only transformer of the port: the dense family.

The JAX package's ``repro.models.transformer`` holds its parameters as a
pytree with the blocks stacked on a leading layer axis and scans over
them.  Here a :class:`Transformer` module holds the same leaves under the
same names (``embed``, ``unembed``, ``final_norm`` and, per block,
``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``qnorm``, ``knorm``,
``w_gate``, ``w_up``, ``w_down``), one block per layer in an
``nn.ModuleList``, and the forward passes loop over them.  Weights are
stored ``(in, out)`` and applied as ``x @ w``, attention tensors are
``(B, H, S, D)`` and caches ``(L, B, Hkv, Smax, hd)``, as in the JAX
package.  Prefill and training attention is the flash-attention kernel,
decode attention the decode-attention kernel (their plain versions on the
CPU).

Parameters are created frozen (``requires_grad`` false), so the serving
paths, which also run under ``torch.no_grad()``, build no autograd graph;
a trainer calls ``model.requires_grad_()`` on its own model.  With
``cfg.remat`` and gradients recorded, each block runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as the JAX
package's ``jax.checkpoint`` around its scan body.

Decode applies each layer's sliding window and the attention softcap
inside the decode kernel, as the JAX package's ``decode_attention_jnp``
does (gemma2).  Not ported yet (ROADMAP.md, queue 1): the MoE FFN and
decode of more than one new token per step.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._cuda import resolve_device
from repro_torch.kernels.decode_attention import decode_attention

from .config import ModelConfig
from .layers import blocked_attention, rms_norm, rope, rope_tables, swiglu

_ROADMAP = "not ported yet (ROADMAP.md, queue 1)"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and type of a tensor (the counterpart of a
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


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
        raise NotImplementedError(f"MoE blocks are {_ROADMAP}")
    shapes.update({"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)})
    return shapes


def top_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"embed": (cfg.padded_vocab, d), "unembed": (d, cfg.padded_vocab),
            "final_norm": (d,)}


def param_specs(cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree as :class:`TensorSpec` leaves:
    ``embed``, ``unembed``, ``final_norm`` and ``blocks`` with every block
    leaf stacked on a leading layer axis."""
    dt = cfg.torch_dtype
    spec = {name: TensorSpec(shape, dt)
            for name, shape in top_shapes(cfg).items()}
    spec["blocks"] = {name: TensorSpec((cfg.n_layers, *shape), dt)
                      for name, shape in block_shapes(cfg).items()}
    return spec


def _frozen(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One layer's parameters."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        for name, shape in block_shapes(cfg).items():
            setattr(self, name, _frozen(shape, dtype, device))


class Transformer(nn.Module):
    """The parameters of a dense decoder-only transformer, frozen until
    ``requires_grad_()``.  Use :func:`init_params` or
    ``repro_torch.models.convert.params_from_numpy`` to fill them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        dtype = cfg.torch_dtype
        for name, shape in top_shapes(cfg).items():
            setattr(self, name, _frozen(shape, dtype, device))
        self.blocks = nn.ModuleList(Block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _init_scale(stacked_shape: tuple) -> float:
    """The JAX package's scale for a leaf of this shape (with the layer
    axis for block leaves): 1/sqrt(shape[-2]) for 2-D and up, else 0.02.
    A block's (L, hd) ``qnorm``/``knorm`` thus draws at 1/sqrt(L), as
    there."""
    if len(stacked_shape) >= 2:
        return 1.0 / math.sqrt(stacked_shape[-2])
    return 0.02


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> Transformer:
    """Random parameters drawn on ``device`` (the card unless named) from
    ``generator`` (or a seed), at the JAX package's scales
    (``transformer.py:65-81``): normal · 1/sqrt(fan_in), with
    ``final_norm``, ``ln1`` and ``ln2`` at zero (``rms_norm`` applies
    ``1 + scale``).  The numbers differ from ``jax.random``'s; tests carry
    the JAX package's parameters across with ``params_from_numpy``."""
    model = Transformer(cfg, device)
    dev = model.device
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))

    def fill(param: nn.Parameter, stacked_shape: tuple) -> None:
        x = torch.randn(param.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        param.copy_(x.mul_(_init_scale(stacked_shape)))

    for name, shape in top_shapes(cfg).items():
        fill(getattr(model, name), shape)
    for blk in model.blocks:
        for name, shape in block_shapes(cfg).items():
            fill(getattr(blk, name), (cfg.n_layers, *shape))
    model.final_norm.zero_()
    for blk in model.blocks:
        blk.ln1.zero_()
        blk.ln2.zero_()
    return model


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------
def _attention(cfg: ModelConfig, p: Block, x: torch.Tensor, tables, *,
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


def _block(cfg: ModelConfig, p: Block, x: torch.Tensor, tables, *, window,
           cache=None, pos=None) -> torch.Tensor:
    x = x + _attention(cfg, p, rms_norm(x, p.ln1), tables, window=window,
                       cache=cache, pos=pos)
    h = rms_norm(x, p.ln2)
    return x + swiglu(h, p.w_gate, p.w_up, p.w_down)


def window_for(cfg: ModelConfig, layer: int):
    """Per-layer window: gemma2 alternates local (even) and global."""
    if cfg.layer_pattern == "local_global":
        return cfg.sliding_window if layer % 2 == 0 else None
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def _embed(model: Transformer, batch: dict) -> torch.Tensor:
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    return model.embed[tokens.long()]


def forward_hidden(cfg: ModelConfig, model: Transformer, batch: dict):
    """→ (final-normed hidden (B, S, d), aux loss 0.0) — pre-unembed.
    Differentiable; with ``cfg.remat`` and gradients recorded each block
    is recomputed in the backward."""
    x = _embed(model, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    tables = rope_tables(positions, cfg.hd, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer, blk in enumerate(model.blocks):
        window = window_for(cfg, layer)
        if remat:
            x = checkpoint(_block, cfg, blk, x, tables, window=window,
                           use_reentrant=False)
        else:
            x = _block(cfg, blk, x, tables, window=window)
    return rms_norm(x, model.final_norm), 0.0


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


def _check_decode_supported(cfg: ModelConfig, n_new: int = 1) -> None:
    if cfg.n_experts:
        raise NotImplementedError(f"decode of MoE blocks is {_ROADMAP}")
    if n_new != 1:
        raise NotImplementedError(
            f"decode of {n_new} new tokens at once is {_ROADMAP}: the JAX "
            f"package's decode attention has no causal mask among new "
            f"tokens")


@torch.no_grad()
def forward_decode(cfg: ModelConfig, model: Transformer, batch: dict,
                   cache: dict, pos: int):
    """One decode step.  batch["tokens"] (B, 1); cache {"k", "v"} (L, B,
    Hkv, Smax, hd), updated in place; pos: the current length, shared by
    every row.  → (logits (B, 1, V), the same cache).  A position past
    the cache raises (the JAX package's dynamic_update_slice would clamp
    it)."""
    x = _embed(model, batch)
    B, S, _ = x.shape
    _check_decode_supported(cfg, S)
    pos = int(pos)
    smax = cache["k"].shape[3]
    if not 0 <= pos <= smax - S:
        raise ValueError(f"decode position {pos} outside a cache of "
                         f"{smax} positions")
    positions = (pos + torch.arange(S, device=x.device)).expand(B, S)
    tables = rope_tables(positions, cfg.hd, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    kv_len = torch.full((B,), pos + S, dtype=torch.int32, device=x.device)
    for layer, blk in enumerate(model.blocks):
        x = _block(cfg, blk, x, tables, window=window_for(cfg, layer),
                   cache=(ck[layer], cv[layer], kv_len), pos=pos)
    x = rms_norm(x, model.final_norm)
    return unembed(cfg, model, x), cache
