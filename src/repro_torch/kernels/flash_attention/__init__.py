"""Flash attention (causal, GQA, sliding window, softcap) for the port:
the Hopper kernel, its plain version and the ``cuda → plain`` dispatch."""
from .kernel import flash_attention_cuda
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_cuda"]
