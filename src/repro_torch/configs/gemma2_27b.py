"""gemma2-27b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf].  head_dim=128 explicit (32·128 ≠ d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab=256000, head_dim=128,
    layer_pattern="local_global", sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab=512, head_dim=32, sliding_window=16)
