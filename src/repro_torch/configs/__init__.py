"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

A copy of the reference's registry holding the architectures this
package serves; the rest of the zoo comes with later slices.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    EncoderConfig, InputShape, INPUT_SHAPES, MLAConfig, ModelConfig, MoEConfig,
)

ARCH_IDS = ["bert_base", "gpt2_small", "rwkv6_3b"]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(arch_id: str):
    key = _ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ported: "
            f"{ARCH_IDS}); the rest of the zoo comes with the models slice")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()
