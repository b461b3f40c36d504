"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

A copy of the reference's registry holding the architectures this
package serves; the rest of the zoo comes with later slices, each named
in ``_LATER``.
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
    # the paper's own evaluation models (reduced-trainable analogues)
    "bert_base",
    "gpt2_small",
    "rwkv6_3b",
]

# the reference's architectures not ported yet, and the slice each waits for
_LATER = {
    "recurrentgemma_2b": "the RG-LRU slice (head_dim 256)",
    "whisper_medium": "the encoder-decoder slice",
}

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS + list(_LATER)}
_ALIASES.update({"qwen2-1.5b": "qwen2_1_5b",
                 "kimi-k2-1t-a32b": "kimi_k2_1t_a32b"})


def _module(arch_id: str):
    key = _ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if key in _LATER:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet: it waits for "
            f"{_LATER[key]} (ported: {ARCH_IDS})")
    if key not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not in the zoo (ported: "
            f"{ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()
