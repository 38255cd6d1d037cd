"""Plain forward pass of a decoder-only transformer (dense or mixture of
experts), layer by layer, in float32.

Per layer: ``x + attn(rms(x))``, then ``x + ffn(rms(x))``, where ``rms``
is ``x / sqrt(mean(x²) + eps) · (1 + scale)``.  Attention projects to
query, key and value heads (stored ``(in, out)``), normalises each query
and key head by its own ``rms`` where the configuration has a qk-norm,
rotates them by RoPE in split halves (angles in float64), and attends
with grouped key heads, scale ``1/sqrt(head_dim)``, the tanh cap of the
configuration where it has one, and per-query visible keys.  The FFN is
SwiGLU, or for a mixture of experts: softmax over the router's logits,
the ``top_k`` experts with their probabilities renormalised, each expert
taking at most its capacity of a routing group's assignments in the order
the tokens arrived (assignments beyond it are dropped), and the gated sum
of the experts' SwiGLU outputs.

What the serving program decides about its calls is an input here: which
keys each position sees (``kv_end``: position i sees keys ``j <
kv_end[i]``, less a range ``hide[i]`` where given), where it sits
(``positions``: its RoPE position, by default its index), and which
tokens were routed together (``calls``: the
position ranges that one call of the program took for every row, each
cut into routing groups by :func:`routing_groups`).  The weights come
from the benchmark's seeded draw, one layer at a time
(``benchlib.weights``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchlib import weights as W
from benchlib.shape import Shape

from .precision import Precision, tf32

#: routing groups of a call: groups of at least this many tokens
GROUP_TOKENS = 256
MAX_GROUPS = 64
MIN_CAPACITY = 4
#: an assignment within this many ranks of its expert's capacity edge
#: counts as on it: another token's routing flip ahead of it in the group
#: shifts its rank by one
EDGE_RANKS = 2
EXPERT_ROWS = 16384       # tokens an expert product takes at a time


def routing_groups(T: int) -> int:
    """How many equal routing groups a call of ``T`` tokens forms: groups
    of at least 256 tokens, at most 64 of them, as many as divide T."""
    G = max(min(MAX_GROUPS, T // GROUP_TOKENS), 1)
    while T % G:
        G -= 1
    return G


def capacity(t: int, s: Shape) -> int:
    """Assignments an expert takes from a routing group of ``t`` tokens."""
    return max(int(t * s.top_k * s.capacity_factor / s.experts),
               MIN_CAPACITY)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (B, S, H, D) at ``positions`` (S,), split halves."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half))
    ang = positions.to(x.device, torch.float64)[:, None] * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(s: Shape, q, k, v, kv_end: torch.Tensor,
              hide: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S, Hkv, D) → (B, S, Hq·D), in float32
    with TF32 off, a block of queries at a time; ``kv_end`` (S,) on the
    host; ``hide`` (S, 2), where given, a range of keys ``[lo, hi)`` each
    query does not see (empty where ``lo == hi``)."""
    B, S, Hq, D = q.shape
    G = Hq // s.kv_heads
    out = torch.empty((B, S, Hq, D), device=q.device)
    keys = torch.arange(S, device=q.device)
    ends = kv_end.to(q.device)
    step = max(1, (1 << 28) // (Hq * S))
    with tf32(False):
        for b in range(B):
            qb = q[b].transpose(0, 1) / math.sqrt(D)             # (Hq, S, D)
            kb = k[b].transpose(0, 1).repeat_interleave(G, 0)    # (Hq, S, D)
            vb = v[b].transpose(0, 1).repeat_interleave(G, 0)
            for i0 in range(0, S, step):
                i1 = min(S, i0 + step)
                kmin = int(kv_end[i0:i1].min())
                kmax = int(kv_end[i0:i1].max())
                sc = torch.bmm(qb[:, i0:i1], kb[:, :kmax].transpose(1, 2))
                if s.softcap is not None:
                    sc.div_(s.softcap).tanh_().mul_(s.softcap)
                if kmin < kmax:         # keys every query here sees: < kmin
                    sc[..., kmin:].masked_fill_(
                        keys[None, kmin:kmax] >= ends[i0:i1, None],
                        float("-inf"))
                if hide is not None and bool((hide[i0:i1, 0]
                                              < hide[i0:i1, 1]).any()):
                    lo = hide[i0:i1, 0].to(q.device)[:, None]
                    hi = hide[i0:i1, 1].to(q.device)[:, None]
                    kk = keys[None, :kmax]
                    sc.masked_fill_((kk >= lo) & (kk < hi), float("-inf"))
                sc.sub_(sc.amax(-1, keepdim=True)).exp_()
                o = torch.bmm(sc, vb[:, :kmax]).div_(sc.sum(-1, keepdim=True))
                out[b, i0:i1] = o.transpose(0, 1)
    return out.reshape(B, S, Hq * D)


def swiglu(x, w_gate, w_up, w_down, prec: Precision):
    return prec.weight(F.silu(prec.weight(x, w_gate))
                       * prec.weight(x, w_up), w_down)


def dispatch_order(B: int, calls) -> tuple:
    """The (B, S) tokens in the order the program's calls took them (call
    by call, rows then positions within a call) → (flat indices into the
    (B, S) grid, the routing group of each, each group's capacity
    length in tokens)."""
    order, group, sizes = [], [], []
    S = calls[-1][1]
    grid = torch.arange(B * S).view(B, S)
    for p0, p1 in calls:
        idx = grid[:, p0:p1].reshape(-1)
        T = idx.numel()
        G = routing_groups(T)
        order.append(idx)
        group.append(len(sizes) + torch.arange(T) // (T // G))
        sizes.extend([T // G] * G)
    return torch.cat(order), torch.cat(group), sizes


def moe(s: Shape, x: torch.Tensor, w: dict, route, prec: Precision,
        margin: torch.Tensor | None = None,
        ranks: torch.Tensor | None = None):
    """x (N, d) in dispatch order; ``route`` = (group of each token, the
    group sizes) → (N, d).  ``margin`` (N,), where given, is lowered to
    each token's routing margin here: the distance of its k-th router
    logit from the next, in router-logit units, or 0 where one of its
    assignments lies within ``EDGE_RANKS`` of its expert's capacity
    edge; ``ranks`` (N,), where given, to the ranks that lie between its
    nearest assignment and that edge (for the log)."""
    group, sizes = route
    N = x.shape[0]
    E, k = s.experts, s.top_k
    logits = prec.weight(x, w["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True)
    # rank of each (token, choice) among its group's assignments to the
    # same expert, in arrival order
    e_flat = top_e.reshape(-1)
    g_flat = group.to(x.device).repeat_interleave(k)
    onehot = F.one_hot(e_flat, E)
    seen = onehot.cumsum(0) - onehot                  # before this one
    first = torch.zeros(len(sizes), dtype=torch.long, device=x.device)
    first[1:] = torch.tensor(sizes, device=x.device).cumsum(0)[:-1] * k
    base = seen[first]                                # (G, E) at group start
    rank = (seen - base[g_flat]).gather(1, e_flat[:, None])[:, 0]
    cap = torch.tensor([capacity(t, s) for t in sizes],
                       device=x.device)[g_flat]
    keep = rank < cap
    if margin is not None:
        srt = logits.sort(dim=-1, descending=True).values
        edge = srt[:, k - 1] - srt[:, k] if k < E else srt[:, 0] * 0 + 1e9
        # an assignment near the capacity edge (0 for rank cap-1 kept or
        # rank cap dropped) turns on its group's other tokens: margin 0
        dist = torch.where(keep, cap - 1 - rank, rank - cap)
        at_edge = (dist < EDGE_RANKS).view(N, k).any(-1)
        margin.copy_(torch.minimum(margin, edge.masked_fill(at_edge, 0.0)))
        if ranks is not None:
            ranks.copy_(torch.minimum(ranks, dist.view(N, k).amin(-1)))
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    gate = gates.reshape(-1)
    out = torch.zeros_like(x)
    for e in range(E):
        sel = keep & (e_flat == e)
        rows, g = tok[sel], gate[sel]
        wg, wu, wd = w["we_gate"][e], w["we_up"][e], w["we_down"][e]
        for r0 in range(0, rows.numel(), EXPERT_ROWS):
            r = rows[r0:r0 + EXPERT_ROWS]
            y = swiglu(x[r], wg, wu, wd, prec)
            out.index_add_(0, r, y * g[r0:r0 + EXPERT_ROWS, None])
    return out


@torch.no_grad()
def forward(s: Shape, seed: int, tokens: torch.Tensor, kv_end: torch.Tensor,
            calls, out_rows, out_pos, prec: Precision | None = None,
            layer_weights=None, stats: dict | None = None,
            positions=None, hide=None) -> torch.Tensor:
    """Logits (float32) at the indices ``(out_rows[i], out_pos[i])`` of
    the (B, S) ``tokens``, every row at RoPE ``positions`` (S,) (by
    default 0..S-1), index i seeing the keys below ``kv_end[i]`` but
    those in ``hide[i]`` (see :func:`attention`).

    ``layer_weights(layer)`` gives a layer's leaves (``weights.TOP`` the
    top leaves); by default the seeded draw on the tokens' device.  Where
    ``stats`` is given and the model routes, ``stats["margin"]`` and
    ``stats["ranks"]`` (B·S,) receive each token's least routing margin
    and capacity-edge distance over the layers (see :func:`moe`)."""
    prec = prec or Precision("fp32")
    dev = tokens.device
    if layer_weights is None:
        def layer_weights(layer):
            if layer == W.TOP:
                return W.draw_top(s, seed, dev)
            return W.draw_layer(s, seed, layer, dev)
    B, S = tokens.shape
    kv_end = torch.as_tensor(kv_end).cpu()
    positions = torch.arange(S) if positions is None \
        else torch.as_tensor(positions)
    hide = None if hide is None else torch.as_tensor(hide).cpu()
    top = layer_weights(W.TOP)
    x = top["embed"][tokens].float()                  # (B, S, d)
    del top
    route = None
    if s.experts:
        order, group, sizes = dispatch_order(B, calls)
        order = order.to(dev)
        route = (group, sizes)
        margin = torch.full((B * S,), float("inf"), device=dev)
        ranks = torch.full((B * S,), 1 << 30, device=dev)
    for layer in range(s.layers):
        w = layer_weights(layer)
        h = rms(x, w["ln1"], s.eps)
        q = prec.weight(h, w["wq"]).view(B, S, s.heads, s.hd)
        kk = prec.weight(h, w["wk"]).view(B, S, s.kv_heads, s.hd)
        v = prec.weight(h, w["wv"]).view(B, S, s.kv_heads, s.hd)
        del h
        if s.qk_norm:
            q = rms(q, w["qnorm"], s.eps)
            kk = rms(kk, w["knorm"], s.eps)
        q, kk = rope(q, positions, s.theta), rope(kk, positions, s.theta)
        a = attention(s, q, kk, v, kv_end, hide)
        del q, kk, v
        x += prec.weight(a, w["wo"])
        del a
        h = rms(x, w["ln2"], s.eps)
        if s.experts:
            m, r = margin[order], ranks[order]
            h = h.reshape(B * S, s.d)[order]
            y = moe(s, h, w, route, prec, m, r)
            del h
            margin[order], ranks[order] = m, r
            x.view(B * S, s.d).index_add_(0, order, y)
            del y
        else:
            x += swiglu(h, w["w_gate"], w["w_up"], w["w_down"], prec)
            del h
        del w
    if stats is not None and s.experts:
        stats["margin"], stats["ranks"] = margin, ranks
    top = layer_weights(W.TOP)
    rows = torch.as_tensor(out_rows, device=dev)
    pos = torch.as_tensor(out_pos, device=dev)
    hf = rms(x[rows, pos], top["final_norm"], s.eps)
    return prec.weight(hf, top["unembed"])


def greedy_gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the
    reference's best, per row."""
    tokens = torch.as_tensor(tokens, device=ref_logits.device).long()
    return ref_logits.max(-1).values \
        - ref_logits.gather(1, tokens[:, None])[:, 0]
