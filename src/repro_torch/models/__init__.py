"""Models of the PyTorch port: the dense transformer family, its config,
the parameter converter from the JAX package's tree and the uniform API
(``repro_torch.models.api``)."""
from .config import ModelConfig

__all__ = ["ModelConfig"]
