"""Model configuration — one dataclass covering the 10 assigned families.

The port's copy of the JAX package's ``repro.models.config``: the same
fields, defaults and derived sizes; ``torch_dtype`` takes the place of
``jdtype``."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # defaults to d_model // n_heads

    # attention options
    qk_norm: bool = False
    attn_softcap: float | None = None      # gemma2 attention logit softcap
    final_softcap: float | None = None     # gemma2 final logit softcap
    sliding_window: int | None = None      # local layers' window
    layer_pattern: str = "global"          # "local_global" alternates
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False            # llama4-style shared expert
    capacity_factor: float = 1.25

    # SSM / linear attention
    ssm_state: int = 0                     # mamba2 state size
    wkv_head_dim: int = 64                 # rwkv6 head dim
    attn_every: int = 0                    # zamba2: shared attn cadence
    conv_width: int = 4                    # mamba conv window

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    n_frames: int = 0                      # stub frontend output length

    # VLM (llava)
    n_patches: int = 0                     # stub patch embeddings per image

    dtype: str = "bfloat16"
    # training
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the unembedding (and
        the CE loss) shard over the 16-way model axis; padded logit columns
        are masked to −inf in the loss and at sampling time."""
        return -(-self.vocab // 128) * 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_wkv_heads(self) -> int:
        return self.d_model // self.wkv_head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced-config variant (smoke tests)."""
        return dataclasses.replace(self, **overrides)

    # ---- parameter counting (roofline MODEL_FLOPS = 6·N·D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (Hq + 2 * Hkv) + Hq * hd * d
        dense_mlp = 3 * d * ff
        n = 0
        if self.family in ("dense", "vlm"):
            n = L * (attn + dense_mlp)
        elif self.family == "moe":
            e = (self.top_k if active_only else self.n_experts)
            mlp = 3 * d * ff * e + (3 * d * ff if self.shared_expert else 0)
            n = L * (attn + mlp + d * self.n_experts)
        elif self.family == "ssm":       # rwkv6
            H = self.n_wkv_heads
            # time-mix: wr,wk,wv,wg,wo (5·d²) + ddlerp/decay LoRAs;
            # channel-mix: ck (d·ff) + cv (ff·d) + cr (d²)
            wkv = 5 * d * d + 11 * 64 * d + H * self.wkv_head_dim
            cmix = 2 * d * ff + d * d
            n = L * (wkv + cmix)
        elif self.family == "hybrid":    # zamba2: mamba blocks have no MLP
            d_in = 2 * d
            H = d_in // 64
            mamba = d * (2 * d_in + 2 * self.ssm_state + H) + d_in * d
            n = L * mamba + (attn + dense_mlp)  # + one shared block
        elif self.family == "audio":
            n = (self.encoder_layers + L) * (attn + dense_mlp) + \
                L * attn  # cross attention
        n += 2 * d * self.vocab + d
        return int(n)
