"""RWKV-6 "Finch" 3B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32L d_model=2560 d_ff=8960 vocab=65536. Head dim 64
(40 heads). AttMemo is inapplicable (no APM). A copy of the reference's
``configs/rwkv6_3b.py``. ``optimized()`` is the reference's mesh variant
(the recurrent scan's operands batch-sharded over the device mesh); it
sets ``act_shard_batch``, a placement hint that one controller does not
act on, so the dry run's one-controller count of it (``whole``) equals
the default's, and one device's program of a grid (``full``) does.
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


def optimized() -> ModelConfig:
    """The reference's adopted pair-2 (it6) configuration: the
    batch-sharded recurrent scan (``act_shard_batch``), one activation
    resharding a layer in place of one a scan step on its mesh."""
    return CONFIG.replace(act_shard_batch=("data", "model"))
