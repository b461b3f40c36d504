"""DeepSeek-7B — dense llama-architecture decoder (MHA).

[arXiv:2401.02954] 30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    decode_window=8192,
    source="[arXiv:2401.02954]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=512,
    )
