"""Training step of the port: CE loss (+z-loss), gradient accumulation,
remat — the JAX package's ``repro.train.train_step``.

The loss unembeds the hidden states :data:`LOSS_CHUNK` positions at a
time, each chunk under ``torch.utils.checkpoint`` (the counterpart of the
JAX package's ``jax.checkpoint`` around its scan step), so the (B, S, V)
logits are never materialised: the backward recomputes one chunk's
logits at a time.  The forward runs the model's blocks, rematerialised
where ``cfg.remat``, and attention through the flash-attention kernel on
the card (``repro_torch.models.layers.FlashAttention``).  Gradients come
from ``torch.autograd.grad``; with ``microbatches > 1`` they accumulate in
float32 and are divided by the count, as the JAX package's scan does.
The update is :func:`~repro_torch.train.optimizer.adamw_update`, in
place.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import api

from .optimizer import AdamWConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # grad-accumulation steps
    z_loss: float = 1e-4
    aux_loss_weight: float = 1e-2
    optimizer: AdamWConfig = AdamWConfig()


LOSS_CHUNK = 512  # sequence positions unembedded at a time


def _ce_chunk(cfg, unemb, hidden_c, labels_c):
    """CE + z-loss sums for one sequence chunk; never keeps full logits."""
    logits = hidden_c @ unemb
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap)
    logits = logits.float()
    # vocab is padded to a shardable multiple (ModelConfig.padded_vocab);
    # padded columns are excluded from the partition function
    if cfg.padded_vocab != cfg.vocab:
        logits = logits.masked_fill(
            torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab,
            -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    # the label's logit: the one term of the JAX package's masked sum
    ll = logits.gather(-1, labels_c.long()[..., None])[..., 0]
    return torch.sum(logz - ll), torch.sum(torch.square(logz))


def loss_fn(cfg, params, batch, tcfg: TrainConfig):
    """Chunked-softmax CE: the (B,S,V) logits tensor is never materialized —
    hidden states are unembedded LOSS_CHUNK positions at a time, each
    chunk rematerialized (memory ≈ B·chunk·V instead of B·S·V).
    → (total loss, {"ce", "aux", "z"}), scalars on the model's device."""
    hidden, aux = api.forward_hidden(cfg, params, batch)
    labels = torch.as_tensor(batch["labels"], device=hidden.device)
    B, S, d = hidden.shape
    chunk = min(LOSS_CHUNK, S)
    if S % chunk:
        chunk = S          # odd lengths: single chunk (tests/smoke only)
    n_tok = B * S
    unemb = params.unembed
    ce_sum, z_sum = 0.0, 0.0
    for c0 in range(0, S, chunk):
        dce, dz = checkpoint(_ce_chunk, cfg, unemb, hidden[:, c0:c0 + chunk],
                             labels[:, c0:c0 + chunk], use_reentrant=False)
        ce_sum = ce_sum + dce
        z_sum = z_sum + dz
    ce = ce_sum / n_tok
    z = z_sum / n_tok
    total = ce + tcfg.z_loss * z + tcfg.aux_loss_weight * aux
    return total, {"ce": ce, "aux": aux, "z": z}


def _split_microbatches(batch, n):
    def split(x):
        B = x.shape[0]
        assert B % n == 0, f"batch {B} not divisible by microbatches {n}"
        return x.reshape(n, B // n, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns step(params, opt_state, batch) → (params, opt_state, metrics).

    ``params`` is a model whose parameters require grad (it is updated in
    place and returned); ``batch`` holds "tokens" and "labels" on its
    device.  ``metrics``: "loss" and "grad_norm" as device scalars, "lr"
    a float — read them back with one transfer a step."""

    def grads_of(params, leaves, batch):
        loss, metrics = loss_fn(cfg, params, batch, tcfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), metrics, dict(zip(leaves, grads))

    def step(params, opt_state, batch):
        leaves = dict(params.named_parameters())
        n = tcfg.microbatches
        if n == 1:
            loss, _, grads = grads_of(params, leaves, batch)
        else:
            micro = _split_microbatches(batch, n)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in leaves.items()}
            loss = 0.0
            for i in range(n):
                mb_loss, _, mb_grads = grads_of(
                    params, leaves, {k: v[i] for k, v in micro.items()})
                for k, g in mb_grads.items():
                    grads[k] += g
                loss = loss + mb_loss
            for g in grads.values():
                g /= n
            loss = loss / n
        _, opt_state, opt_metrics = adamw_update(
            leaves, grads, opt_state, tcfg.optimizer)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return step
