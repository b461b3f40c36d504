"""GPT-2 small analogue — the paper's decoder evaluation model.

[Radford et al.] 12L d_model=768 12H d_ff=3072. A copy of the
reference's ``configs/gpt2_small.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-small",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=50257,
    norm="layernorm",
    act="gelu",
    glu=False,
    tie_embeddings=True,
    source="[Radford et al. 2019]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gpt2-reduced", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=512,
    )
