"""Model / run configuration dataclasses.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (the full paper-table config) and ``reduced()`` (a CPU-smoke
variant of the same family: <=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    # number of token chunks the EP path scans over to bound the top_k x
    # activation inflation (see DESIGN.md §5).
    dispatch_chunks: int = 8


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder consuming precomputed frame embeddings (stub
    frontend -- see DESIGN.md §4)."""
    n_layers: int = 24
    n_frames: int = 1500           # fixed post-conv frame count
    d_model: int = 1024
    n_heads: int = 16
    d_ff: int = 4096


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads
    mixer: str = "gqa"             # gqa | mla | rwkv6 | rglru_hybrid
    # hybrid pattern unit, e.g. ("rglru", "rglru", "attn"); repeated/truncated
    # to n_layers. ("mix",) means homogeneous `mixer`.
    layer_pattern: Tuple[str, ...] = ("mix",)
    qk_norm: bool = False
    qkv_bias: bool = False
    causal: bool = True            # False -> encoder-style bidirectional
    n_classes: int = 0             # >0 adds a mean-pool classification head
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    glu: bool = True               # gated MLP (SwiGLU/GeGLU) vs plain 2-layer
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # local attention window (training)
    # decode-time window for the long_500k sub-quadratic variant on otherwise
    # full-attention archs (None -> full cache attention at decode).
    decode_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    dense_first_n: int = 0         # kimi: leading dense layers before MoE
    dense_d_ff: int = 0            # d_ff of those leading dense layers
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None  # audio | vision (stubbed embeddings)
    # rwkv6
    rwkv_head_dim: int = 64
    # shard the recurrent-scan batch (and states) over these mesh axes —
    # rwkv hillclimb it4: heads (40) don't divide the model axis, the
    # batch does (DESIGN/EXPERIMENTS §Perf)
    act_shard_batch: Optional[Tuple[str, ...]] = None
    # rglru
    conv_width: int = 4
    rglru_c: float = 8.0
    # AttMemo integration: which layers are memoizable (APM exists).
    # Computed from the pattern; rwkv6 -> none.
    optimizer: str = "adamw"       # adamw | adafactor (hints the trainer)
    source: str = ""               # citation bracket from the assignment

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind, length n_layers."""
        if self.layer_pattern == ("mix",):
            base = {"gqa": "attn", "mla": "mla", "rwkv6": "rwkv6"}[self.mixer]
            kinds = [base] * self.n_layers
        else:
            kinds = [self.layer_pattern[i % len(self.layer_pattern)]
                     for i in range(self.n_layers)]
        return tuple(kinds)

    def memoizable_layers(self) -> Tuple[int, ...]:
        """Layers with an attention-probability matrix (AttMemo-applicable)."""
        return tuple(i for i, k in enumerate(self.layer_kinds())
                     if k in ("attn", "mla"))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers + head)."""
        d, v = self.d_model, self.vocab
        total = v * d                      # token embedding
        if not self.tie_embeddings:
            total += v * d                 # lm head
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            total += 2 * d                 # two norms (scale only; rmsnorm)
            total += self._mixer_params(kind)
            total += self._channel_params(i)
        total += d                         # final norm
        if self.encoder is not None:
            e = self.encoder
            total += e.n_layers * (
                2 * e.d_model
                + 4 * e.d_model * e.d_model          # qkvo
                + 2 * e.d_model * e.d_ff)            # mlp
            total += e.d_model                        # enc final norm
            # decoder cross-attention per layer
            total += self.n_layers * (4 * d * d + d)
        return total

    def _mixer_params(self, kind: str) -> int:
        d, H, Hkv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        if kind == "attn":
            p = d * H * dh + 2 * d * Hkv * dh + H * dh * d
            if self.qkv_bias:
                p += (H + 2 * Hkv) * dh
            if self.qk_norm:
                p += 2 * dh
            return p
        if kind == "mla":
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank          # q down + norm
            p += m.q_lora_rank * H * qk_head               # q up
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
            p += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
            p += H * m.v_head_dim * d                      # o proj
            return p
        if kind == "rwkv6":
            nh = d // self.rwkv_head_dim
            lora = 64
            p = 5 * d * lora * 2 + 6 * d                   # ddlerp loras + mu
            p += 4 * d * d                                 # r,k,v,g  (w is lora)
            p += d * lora * 2                              # decay lora
            p += d                                         # u (bonus)
            p += nh * self.rwkv_head_dim                   # group-norm scale
            p += d * d                                     # output
            return p
        if kind == "rglru":
            dr = d                                          # recurrent width
            p = 2 * d * dr                                  # x branch + gate branch in
            p += self.conv_width * dr                       # temporal conv
            p += 2 * dr * dr + 2 * dr                       # W_a, W_x gates + biases
            p += dr                                         # Λ (per-dim decay)
            p += dr * d                                     # out linear
            return p
        raise ValueError(kind)

    def _channel_params(self, layer_idx: int) -> int:
        d = self.d_model
        kinds = self.layer_kinds()
        if kinds[layer_idx] == "rwkv6":
            return 2 * d * int(3.5 * d) + d  # rwkv channel-mix approx
        if self.moe is not None and layer_idx >= self.dense_first_n:
            m = self.moe
            mult = 3 if self.glu else 2
            return d * m.n_experts + m.n_experts * mult * d * m.d_ff
        ff = self.dense_d_ff if (self.moe is not None and
                                 layer_idx < self.dense_first_n and
                                 self.dense_d_ff) else self.d_ff
        mult = 3 if self.glu else 2
        return mult * d * ff

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        mult = 3 if self.glu else 2
        n_moe_layers = self.n_layers - self.dense_first_n
        all_experts = n_moe_layers * m.n_experts * mult * self.d_model * m.d_ff
        active = n_moe_layers * m.top_k * mult * self.d_model * m.d_ff
        return full - all_experts + active

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned, global)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
