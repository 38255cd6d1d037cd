"""whisper-small [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, encoder_layers=12, n_frames=1500,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                      d_ff=128, vocab=256, encoder_layers=2, n_frames=32)
