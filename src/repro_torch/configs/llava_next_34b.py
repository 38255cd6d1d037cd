"""llava-next-34b [vlm] — anyres tiling; backbone only, patch embeddings
stubbed [hf:llava-hf/llava-v1.6; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, n_patches=576,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab=512, n_patches=16)
