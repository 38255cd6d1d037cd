"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536, wkv_head_dim=64,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                      d_ff=256, vocab=512, wkv_head_dim=64)
