"""Architecture registry of the port (the JAX package's ``repro.configs``).

``get_config(name)`` returns the full published configuration and
``get_config(name, smoke=True)`` the reduced same-family variant the CPU
tests use. Every architecture of the JAX package is listed.
"""
from __future__ import annotations

import importlib

from ..nn.common import ModelConfig

ARCHS = ["gemma3_4b", "granite_moe_1b_a400m", "gemma2_9b", "qwen2_7b",
         "granite_34b", "deepseek_moe_16b", "mamba2_130m", "zamba2_1p2b",
         "seamless_m4t_medium", "llava_next_34b"]


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "p")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    arch = canonical(name)
    if arch not in ARCHS:
        raise ValueError(f"unknown or not yet ported arch {name!r}; "
                         f"ported: {ARCHS}")
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.smoke_config() if smoke else mod.config()
