"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427] 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
Pattern (rec, rec, attn) repeated; local-attention window 2048. Natively
sub-quadratic — runs long_500k as-is.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    mixer="rglru_hybrid",
    layer_pattern=("rglru", "rglru", "attn"),
    sliding_window=2048,
    act="gelu",
    conv_width=4,
    tie_embeddings=True,
    source="[arXiv:2402.19427]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-reduced", n_layers=3, d_model=256, n_heads=2,
        n_kv_heads=1, d_head=128, d_ff=512, vocab=512, sliding_window=64,
    )
