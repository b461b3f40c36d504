"""BERT-base analogue — the paper's primary evaluation model (encoder).

[arXiv:1810.04805] 12L d_model=768 12H d_ff=3072. A copy of the
reference's ``configs/bert_base.py``: bidirectional attention == causal
mask off.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-base",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=30522,
    causal=False,
    norm="layernorm",
    act="gelu",
    glu=False,
    source="[arXiv:1810.04805]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="bert-reduced", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=512,
    )
