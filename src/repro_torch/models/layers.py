"""Shared building blocks of the port's transformer: norms, RoPE, blocked
attention and the gated MLP.

The JAX package computes attention in its models with jnp
(``repro.models.layers.blocked_attention``, "same semantics as
kernels.flash_attention.ref") and keeps its Pallas kernels beside them as
a drop-in.  Here the drop-in is real: ``blocked_attention`` on a CUDA
tensor is the hand-written flash-attention kernel, on a CPU tensor its
plain version.

Training differentiates through it with :class:`FlashAttention`, an
``autograd.Function``: its forward is that same kernel (or, on the CPU,
that plain version); its backward, :func:`attention_grads`, recomputes
attention over kv blocks of 1,024 in PyTorch ops and returns dq, dk and
dv.  That is the counterpart of the JAX package's gradient, which is XLA
autodiff through its jnp ``blocked_attention`` with each kv block
rematerialised (``repro/models/layers.py:90-92``): no Pallas kernel of
the JAX package has a backward, so none is ported.

The MoE FFN (:func:`moe_ffn`, :func:`aux_load_balance_loss`) is the JAX
package's, computed in PyTorch ops as it computes it in jnp outside any
Pallas kernel: routing, an expert-sorted dispatch into a capacity-padded
(E, C, d) buffer per routing group, batched expert products and a gated
scatter back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import live_mask
from repro_torch.spans import span


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) · (1 + scale)`` in float32, cast back to x's type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, d: int, theta: float = 10000.0):
    """(cos, sin) of shape (..., S, 1, d/2) for positions (..., S): the
    rotation angles :func:`rope` applies, computed once per forward."""
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding, split-halves form (not interleaved), in float32,
    cast back.  x (..., S, H, D); ``tables`` from :func:`rope_tables` for
    the positions (..., S)."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


NEG_INF = -1e30
BLOCK_K = 1024        # the JAX package's block_k: keys a backward block


def _attention_out(q: torch.Tensor) -> torch.Tensor:
    """An empty (B, Hq, Sq, D) result laid out as (B, Sq, Hq, D), so that
    the model's ``transpose(1, 2).reshape(B, Sq, Hq * D)`` copies
    nothing."""
    B, Hq, Sq, D = q.shape
    return torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      softcap: float | None = None,
                      q_offset: int | None = None,
                      kv_length: torch.Tensor | None = None,
                      block_k: int = BLOCK_K,
                      scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) → (B, Hq, Sq, D) in q's
    type (a view of a (B, Sq, Hq, D) buffer): the flash-attention kernel
    on the card, its plain version on the CPU, through
    :class:`FlashAttention` (which records a graph only where grad is
    enabled and an input requires it).

    Query i sits at ``q_offset + i`` (default ``Skv − Sq``: end-aligned);
    ``kv_length`` (B,) limits batch row b's keys to ``[0,
    kv_length[b])``, attention over a padded cache (a chunked prefill,
    prompts of several lengths in one batch).  A query with no live key
    gets 0, where the JAX package returns a ``block_k``-dependent mean of
    zero-padded values.  ``block_k`` sets the kv blocks of the plain
    version on the CPU and of the backward; on the card the kernel keeps
    its own tiles."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                q_offset, kv_length, block_k)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is :func:`flash_attention`
    (the kernel on the card, launched once a call, and again when a
    rematerialised block recomputes it); the backward is
    :func:`attention_grads` in PyTorch ops with the forward's masks.
    Neither calls the kernel's plain version on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale,
                q_offset=None, kv_length=None, block_k=BLOCK_K):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale,
                              q_offset=q_offset, kv_length=kv_length,
                              block_k=block_k, out=_attention_out(q))
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale, q_offset=q_offset, kv_length=kv_length,
                        block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_grads(q, k, v, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None


def attention_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    scale: float | None = None, q_offset: int | None = None,
                    kv_length: torch.Tensor | None = None,
                    block_k: int = BLOCK_K):
    """→ (dq, dk, dv) of ``blocked_attention`` for the output gradient
    ``do`` (B, Hq, Sq, D), each in its input's type, computed in float32
    over kv blocks of ``block_k``: a first pass recomputes the output and
    each row's log-sum-exp (the online softmax of the forward), a second
    the probabilities of each block and from them the gradients.  A query
    head's group shares its kv head, so dk and dv sum over the group; the
    causal, window and length masks, the queries' offset and the tanh
    softcap are those of the forward.  A query with no live key has the
    output 0 and passes no gradient."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dev = q.device
    # query head h reads kv head h // G: rows (g, i) of one kv head
    qf = (q.float() * scale).reshape(B, Hkv, G * Sq, D)
    dof = do.float().reshape(B, Hkv, G * Sq, D)
    offset = Skv - Sq if q_offset is None else int(q_offset)
    # (B|1, 1, G·Sq, Skv): the forward's mask for the rows (g, i)
    live = live_mask(Sq, Skv, causal, window, offset, kv_length,
                     dev).repeat(1, G, 1)[:, None]
    blocks = [(slice(j0, j0 + block_k), live[..., j0:j0 + block_k])
              for j0 in range(0, Skv, block_k)]

    def scores(sl):
        s = qf @ k[:, :, sl].float().transpose(-1, -2)
        if softcap is None:
            return s, None
        t = torch.tanh(s / softcap)
        return softcap * t, t

    m = torch.full((B, Hkv, G * Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G * Sq), device=dev)
    acc = torch.zeros_like(qf)
    for sl, live in blocks:
        s = scores(sl)[0].masked_fill(~live, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~live, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v[:, :, sl].float()
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    lse = m + torch.log(l)
    delta = (dof * o).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, Hkv, Skv, D), device=dev)
    dv = torch.empty((B, Hkv, Skv, D), device=dev)
    for sl, live in blocks:
        s, t = scores(sl)
        p = torch.exp(s - lse[..., None]).masked_fill(~live, 0.0)
        dv[:, :, sl] = p.transpose(-1, -2) @ dof
        ds = p * (dof @ v[:, :, sl].float().transpose(-1, -2) - delta)
        if t is not None:
            ds = ds * (1.0 - t * t)
        dq += ds @ k[:, :, sl].float()
        dk[:, :, sl] = ds.transpose(-1, -2) @ qf
    dq = (dq * scale).reshape(B, Hq, Sq, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity dropping via expert-sorted permutation
# ---------------------------------------------------------------------------
MOE_GROUPS = 64  # routing groups; ≥ DP degree so each shard sorts locally


def moe_capacity(t: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Slots an expert has in a routing group of ``t`` tokens."""
    return max(int(t * top_k * capacity_factor / n_experts), 4)


def moe_groups(T: int) -> int:
    """Routing groups of ``T`` tokens: groups of ≥ 256 tokens, at most
    MOE_GROUPS, stepped down until they divide T (decode's few tokens
    route as one group)."""
    G = max(min(MOE_GROUPS, T // 256), 1)
    while T % G:
        G -= 1
    return G


def _moe_group_dispatch(x, gate_vals, experts, we_gate, we_up, we_down,
                        top_k, capacity_factor):
    """Every routing group at once (the JAX package vmaps one group):
    x (G, t, d); gate_vals, experts (G, t, k) → ((G, t, d), the (G, t·k)
    keep mask)."""
    G, t, d = x.shape
    E = we_gate.shape[0]
    C = moe_capacity(t, top_k, capacity_factor, E)
    dev = x.device
    with span("moe.dispatch"):
        flat_e = experts.reshape(G, t * top_k)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        sorted_e = flat_e.gather(-1, order)
        # rank within expert group = position − group start
        group_start = torch.searchsorted(
            sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
        pos_in_e = torch.arange(t * top_k, device=dev) \
            - group_start.gather(-1, sorted_e)
        keep = pos_in_e < C
        slot = torch.where(keep, sorted_e * C + pos_in_e,
                           E * C)                          # overflow slot
        tok = order // top_k
        rows = x.gather(1, tok[..., None].expand(G, t * top_k, d))
        # the overflow slot E·C takes every dropped row (which one lands is
        # unspecified, as in the JAX package); it is cut off unread
        buf = x.new_zeros((G, E * C + 1, d)).scatter(
            1, slot[..., None].expand(G, t * top_k, d), rows)
        # (G, E, C, d) → (E, G·C, d): one batched product an expert
        buf = buf[:, :-1].reshape(G, E, C, d).transpose(0, 1) \
            .reshape(E, G * C, d)
    with span("moe.experts"):
        h = F.silu(torch.bmm(buf, we_gate)) * torch.bmm(buf, we_up)
        y = torch.bmm(h, we_down)
    with span("moe.combine"):
        y = y.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
        idx = torch.clamp(slot, max=E * C - 1)
        contrib = y.gather(1, idx[..., None].expand(G, t * top_k, d))
        contrib = contrib.masked_fill(~keep[..., None], 0)
        g = gate_vals.reshape(G, t * top_k).gather(-1, order)[..., None] \
            .to(x.dtype)
        out = torch.zeros_like(x).scatter_add(
            1, tok[..., None].expand(G, t * top_k, d), contrib * g)
    return out, keep


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """→ (softmax probabilities (T, E), top-k gates (T, k), experts (T,
    k)), the logits in float32."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts = torch.topk(probs, top_k, dim=-1)
    return probs, gate_vals, experts


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, we_gate: torch.Tensor,
            we_up: torch.Tensor, we_down: torch.Tensor, *, top_k: int,
            capacity_factor: float) -> torch.Tensor:
    """x (T, d) → (T, d): top-k routing with renormalised gates, then per
    routing group (:func:`moe_groups`) an argsort of the (token, expert)
    assignments by expert, the first :func:`moe_capacity` of each expert
    gathered into an (E, C, d) buffer, the expert SwiGLU as batched
    products, and the gated outputs scattered back; assignments beyond
    capacity are dropped (:func:`_moe_group_dispatch` also returns which
    were kept)."""
    T, d = x.shape
    with span("moe.route"):
        _, gate_vals, experts = _route(x, router_w, top_k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True) \
            .clamp_min(1e-9)
    G = moe_groups(T)
    out, _ = _moe_group_dispatch(
        x.reshape(G, T // G, d), gate_vals.reshape(G, T // G, top_k),
        experts.reshape(G, T // G, top_k), we_gate, we_up, we_down, top_k,
        capacity_factor)
    return out.reshape(T, d)


def aux_load_balance_loss(x: torch.Tensor, router_w: torch.Tensor,
                          top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction·prob per
    expert)."""
    probs, _, experts = _route(x, router_w, top_k)
    E = probs.shape[-1]
    onehot = F.one_hot(experts, E).sum(dim=-2).float()       # (T, E)
    frac = onehot.mean(dim=0) / top_k
    imp = probs.mean(dim=0)
    return E * torch.sum(frac * imp)
