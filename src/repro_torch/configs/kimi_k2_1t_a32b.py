"""Kimi-K2 1T-A32B — trillion-parameter MoE, 384 experts top-8.

[arXiv:2501.kimi2, paper-table] 61L d_model=7168 64H (GQA kv=8)
expert d_ff=2048 vocab=163840, MoE 384e top-8; leading dense layer.
Trains with Adafactor (fp32 Adam state is physically >HBM at 256 chips;
see EXPERIMENTS §Dry-run).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, dispatch_chunks=16),
    dense_first_n=1,
    dense_d_ff=18432,
    decode_window=8192,
    optimizer="adafactor",
    source="[arXiv:2501.kimi2]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, dispatch_chunks=2),
        dense_first_n=1, dense_d_ff=512,
    )
