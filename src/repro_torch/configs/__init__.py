"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

A copy of the reference's registry: every architecture of the
reference's zoo, with its aliases.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    EncoderConfig, InputShape, INPUT_SHAPES, MLAConfig, ModelConfig, MoEConfig,
)

ARCH_IDS = [
    "minicpm3_4b",
    "deepseek_7b",
    "qwen2_1_5b",
    "chameleon_34b",
    "dbrx_132b",
    "kimi_k2_1t_a32b",
    "qwen3_8b",
    "recurrentgemma_2b",
    "whisper_medium",
    # the paper's own evaluation models (reduced-trainable analogues)
    "bert_base",
    "gpt2_small",
    "rwkv6_3b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({"qwen2-1.5b": "qwen2_1_5b",
                 "kimi-k2-1t-a32b": "kimi_k2_1t_a32b"})


def _module(arch_id: str):
    key = _ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise ValueError(
            f"architecture {arch_id!r} is not in the zoo (ported: "
            f"{ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()
