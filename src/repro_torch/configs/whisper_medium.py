"""Whisper-medium — encoder-decoder speech model (backbone only).

[arXiv:2212.04356] 24L d_model=1024 16H d_ff=4096 vocab=51865. The
mel-spectrogram + conv frontend is STUBBED per the assignment:
``input_specs`` feeds precomputed (B, 1500, 1024) frame embeddings.
Decoder is 24L causal with cross-attention to the encoder.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,                 # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    glu=False,
    encoder=EncoderConfig(n_layers=24, n_frames=1500, d_model=1024,
                          n_heads=16, d_ff=4096),
    frontend="audio",
    decode_window=8192,
    source="[arXiv:2212.04356]",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=512,
        encoder=EncoderConfig(n_layers=2, n_frames=64, d_model=256,
                              n_heads=4, d_ff=512),
    )
