"""Models of the PyTorch port: the transformer (dense, MoE, VLM), RWKV6,
the Zamba2 hybrid and whisper, their config, the parameter converter from
the JAX package's tree and the uniform API (``repro_torch.models.api``)."""
from .config import ModelConfig

__all__ = ["ModelConfig"]
