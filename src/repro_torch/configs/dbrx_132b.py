"""DBRX-132B — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base] 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752),
    decode_window=8192,
    optimizer="adafactor",
    source="[hf:databricks/dbrx-base]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="dbrx-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=512, dispatch_chunks=2),
    )
