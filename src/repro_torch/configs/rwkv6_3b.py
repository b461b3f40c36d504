"""RWKV-6 "Finch" 3B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32L d_model=2560 d_ff=8960 vocab=65536. Head dim 64
(40 heads). AttMemo is inapplicable (no APM). A copy of the reference's
``configs/rwkv6_3b.py`` without ``optimized()``, the reference's
mesh-sharded variant (batch-sharded scan over a device mesh), which waits
for the sharding slice.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    mixer="rwkv6",
    rwkv_head_dim=64,
    glu=False,                  # rwkv channel-mix is its own shape
    source="[arXiv:2404.05892]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="rwkv6-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=896, vocab=512, rwkv_head_dim=64,
    )
