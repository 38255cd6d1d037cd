"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks, ssm_state=64
[arXiv:2411.15242; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, ssm_state=64, attn_every=6,
)

SMOKE = CONFIG.scaled(n_layers=6, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=256, vocab=512, ssm_state=16, attn_every=3)
