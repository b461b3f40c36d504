"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B] 62L d_model=2560 40H (GQA kv=40) d_ff=6400
vocab=73448. MLA ranks follow the model card (q_lora 768, kv_lora 256,
qk rope 32 / nope 64, v 64).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=96,                  # qk_nope(64) + qk_rope(32)
    d_ff=6400,
    vocab=73448,
    mixer="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    decode_window=8192,         # sub-quadratic long_500k variant
    tie_embeddings=True,
    source="[hf:openbmb/MiniCPM3-4B]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="minicpm3-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_head=96, d_ff=512, vocab=512,
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
    )


def optimized() -> ModelConfig:
    """Adopted §Perf pair-1 configuration (EXPERIMENTS.md): padded vocab
    (shardable lm_head) + batch-sharded activations. Use with sharding
    rules overrides {'q_lora': 'model', 'kv_lora': 'model'}. 12.8x on the
    dominant roofline term vs CONFIG."""
    return CONFIG.replace(vocab=73728, act_shard_batch=("data", "model"))
