"""Chameleon-34B — early-fusion VLM decoder (VQ image tokens, qk-norm).

[arXiv:2405.09818] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
The VQ-VAE image tokenizer is STUBBED per the assignment: image patches
arrive as ids in the shared 65536 vocab, so input_specs is plain token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    frontend="vision",
    decode_window=8192,
    optimizer="adafactor",
    source="[arXiv:2405.09818]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="chameleon-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512,
    )
