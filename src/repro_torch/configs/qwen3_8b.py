"""Qwen3-8B — dense decoder with GQA (kv=8) and qk-norm.

[hf:Qwen/Qwen3-8B] 36L d_model=4096 32H (kv=8) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    decode_window=8192,
    source="[hf:Qwen/Qwen3-8B]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512,
    )
