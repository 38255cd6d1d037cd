"""Assigned architecture configs (``--arch <id>``), the port's copy of
the JAX package's ``repro.configs``: data only.

Each module exports CONFIG (the exact published configuration) and
SMOKE (a reduced same-family config for CPU smoke tests).  All ten are
carried across; the port's models run the dense family without a sliding
window or a logit softcap (``repro_torch.models.api``).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "deepseek_coder_33b", "qwen3_14b", "glm4_9b", "gemma2_27b",
    "llama4_scout_17b_a16e", "grok1_314b", "rwkv6_7b", "llava_next_34b",
    "zamba2_1p2b", "whisper_small",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-14b": "qwen3_14b",
    "glm4-9b": "glm4_9b",
    "gemma2-27b": "gemma2_27b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "grok-1-314b": "grok1_314b",
    "rwkv6-7b": "rwkv6_7b",
    "llava-next-34b": "llava_next_34b",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-small": "whisper_small",
})


def get_config(arch: str, smoke: bool = False):
    mod_name = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCHS}
