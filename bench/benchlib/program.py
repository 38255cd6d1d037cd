"""The program under test, ``repro_torch``: its configuration built from a
configuration file, its parameter tree filled with the seeded weights.
The program is imported here, when a run asks for it, and nowhere in
the reference."""
from __future__ import annotations

from . import weights
from .shape import Shape

#: the program's RMSNorm epsilon (``repro_torch.models.layers.rms_norm``)
PROGRAM_EPS = 1e-6


def model_config(s: Shape):
    """The program's ``ModelConfig`` for the sizes ``s``."""
    from repro_torch.models.config import ModelConfig
    if s.eps != PROGRAM_EPS:
        raise ValueError(f"{s.name}: the program's norms use eps "
                         f"{PROGRAM_EPS}, the configuration {s.eps}")
    return ModelConfig(
        name=s.name, family=s.family, n_layers=s.layers, d_model=s.d,
        n_heads=s.heads, n_kv_heads=s.kv_heads, d_ff=s.ff, vocab=s.vocab,
        head_dim=s.hd, qk_norm=s.qk_norm, attn_softcap=s.softcap,
        rope_theta=s.theta, n_experts=s.experts, top_k=s.top_k,
        capacity_factor=s.capacity_factor, dtype=s.dtype)


def build_model(s: Shape, seed: int, device):
    """→ (the program's config, its parameters holding the seeded
    weights)."""
    from repro_torch.models import api
    cfg = model_config(s)
    if cfg.padded_vocab != cfg.vocab:
        raise ValueError(f"{s.name}: vocab {s.vocab} is not a multiple of "
                         f"128; the program would pad it")
    model = api.empty_params(cfg, device)
    weights.fill_program(model, s, seed)
    return cfg, model
