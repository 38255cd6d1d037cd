"""Chunked linear-attention scan — shared by RWKV6 (WKV) and Mamba2 (SSD);
the port's copy of the JAX package's ``repro.models.linear_scan``.

Recurrence (per head; S is an (N, P) state matrix, decay on the N axis):

    S_t = diag(a_t) S_{t−1} + k_tᵀ v_t          a_t = exp(logw_t)
    o_t = q_t · S_{t−1 or t}  (+ RWKV bonus (q_t ⊙ u)·k_t v_t)

Tokens are processed in chunks of C: intra-chunk contributions are a
(C×C) masked product with per-channel decay factors exp(W_t − W_s)
factorised as (q ⊙ e^{W}) @ (k ⊙ e^{−W})ᵀ; the state flows from chunk to
chunk.  The JAX package runs one ``lax.scan`` step a chunk; here every
chunk's local work (cumulative decays, the masked product, each chunk's
own contribution to the state) is one batched op over all chunks, and the
state's carry is a Python loop over the T/C chunks, two ops a step.  The
arithmetic of each chunk is the JAX package's, in float32 on chunk-local
cumulative decays (exponents bounded by C·max|logw|).  No Pallas kernel
of the JAX package computes it, so it runs in PyTorch ops on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 32


def chunked_linear_scan(q, k, v, logw, state0, *, inclusive: bool,
                        bonus=None, chunk: int = CHUNK):
    """q, k (B, H, T, N); v (B, H, T, P); logw (B, H, T, N) or (B, H, T, 1);
    state0 (B, H, N, P); bonus (H, N) or None (RWKV's u).
    → (out (B, H, T, P) float32, stateT (B, H, N, P) float32).

    inclusive=True  → o_t = q_t·S_t      (Mamba2/SSD)
    inclusive=False → o_t = q_t·S_{t−1} + (q_t⊙u)·k_t v_t   (RWKV6)
    """
    B, H, T, N = q.shape
    P = v.shape[-1]
    T0 = T
    pad = (-T) % chunk
    if pad:
        # zero k/v add nothing to the state and logw=0 means decay 1, so
        # tail padding is exact for both outputs and the final state
        q, k, v, logw = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v, logw))
        T = T + pad
    nc = T // chunk

    def to_chunks(x):                  # (B, H, nc, C, ·) float32
        return x.float().reshape(B, H, nc, chunk, x.shape[-1])

    qc, kc, vc, wc = map(to_chunks, (q, k, v, logw))
    dev = qc.device
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril(
        0 if inclusive else -1)
    W = torch.cumsum(wc, dim=3)        # inclusive cumulative log-decay
    Wq = W if inclusive else W - wc    # exclusive for RWKV
    q_t = qc * torch.exp(Wq)
    k_t = kc * torch.exp(-W)
    A = (q_t @ k_t.transpose(-1, -2)).masked_fill(~tri, 0.0)
    if bonus is not None:
        diag = (qc * bonus.float()[None, :, None, None, :] * kc).sum(-1)
        A = A + torch.diag_embed(diag)
    intra = A @ vc
    Wlast = W[:, :, :, -1:, :]                          # (B, H, nc, 1, ·)
    kd = kc * torch.exp(Wlast - W)
    own = kd.transpose(-1, -2) @ vc                     # (B, H, nc, N, P)
    decay = torch.exp(Wlast[:, :, :, 0, :, None])       # (B, H, nc, ·, 1)
    S = state0.float()
    entering = []
    for c in range(nc):
        entering.append(S)
        S = decay[:, :, c] * S + own[:, :, c]
    inter = q_t @ torch.stack(entering, dim=2)
    out = (intra + inter).reshape(B, H, T, P)
    return out[:, :, :T0], S


def check_one_token(n_new: int) -> None:
    """Raise unless a decode step brings one new token: the non-chunked
    scan (:func:`linear_scan_decode`) steps the state by one token, and
    the JAX package's decode passes it only the first (``[:, 0]``) of
    several, whose shapes then fail to reshape."""
    if n_new != 1:
        raise ValueError(f"decode of {n_new} new tokens a step: the "
                         f"non-chunked scan steps its state one token at a "
                         f"time")


def linear_scan_decode(q, k, v, logw, state, *, inclusive: bool,
                       bonus=None):
    """Single-token recurrence (serving): all inputs (B, H, N|P); state
    (B, H, N, P) → (out (B, H, P), new state), float32."""
    q, k, v = q.float(), k.float(), v.float()
    a = torch.exp(logw.float())                    # (B, H, N) or (B, H, 1)
    kv = k[..., :, None] * v[..., None, :]
    if inclusive:
        S_new = a[..., None] * state + kv
        out = (q[..., None, :] @ S_new)[..., 0, :]
    else:
        out = (q[..., None, :] @ state)[..., 0, :] + \
            ((q * bonus.float()[None])[..., None, :] @ kv)[..., 0, :]
        S_new = a[..., None] * state + kv
    return out, S_new


def sequential_scan_ref(q, k, v, logw, state0, *, inclusive: bool,
                        bonus=None):
    """O(T) sequential oracle for tests → (out (B, H, T, P), stateT)."""
    B, H, T, N = q.shape
    S = state0.float()
    outs = []
    for t in range(T):
        o, S = linear_scan_decode(
            q[:, :, t], k[:, :, t], v[:, :, t],
            logw[:, :, t].expand(B, H, logw.shape[-1]), S,
            inclusive=inclusive, bonus=bonus)
        outs.append(o)
    return torch.stack(outs, dim=2), S
