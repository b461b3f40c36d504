"""Qwen2-1.5B — dense decoder with GQA (kv=2) and QKV bias.

[arXiv:2407.10671] 28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    decode_window=8192,
    source="[arXiv:2407.10671]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512,
    )
