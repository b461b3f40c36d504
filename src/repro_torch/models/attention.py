"""Attention mixers: GQA/MQA/MHA and MLA (Multi-head Latent Attention),
the reference's ``models/attention.py``: the full-sequence apply, the
memo-only apply, one-token decode and the decode caches of each, and
the mesh specs (``gqa_specs``, ``mla_specs``: logical-axis names for
``sharding/rules.py``).

Functions over dicts of tensors whose keys and layouts are the JAX
tree's (``wq (d,H,dh)``, ``wo (H,dh,d)``). Each full-sequence apply can
  * capture the attention-probability matrix (APM) — AttMemo's memoized
    quantity — via ``return_apm=True``;
  * consume a memoized APM override via ``memo=Memo(apm, hit)`` where
    ``apm: (B, H, S, S)`` and ``hit: (B,) bool`` (``idx``, the matched
    slots, rides along for the engine's kernel-mode layer).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init


class Memo(NamedTuple):
    apm: torch.Tensor          # (B, H, Sq, Sk) memoized probabilities
    hit: torch.Tensor          # (B,) bool
    idx: Optional[torch.Tensor] = None   # (B,) matched slots


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def make_mask(sq: int, sk: int, kind: str, window: Optional[int] = None,
              device=None):
    """(sq, sk) boolean mask. kind: causal | bidir."""
    if kind == "bidir" and window is None:
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if kind == "causal":
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _sdpa(q, k, v, mask, scale, memo: Optional[Memo] = None,
          return_apm: bool = False):
    """q: (B,Sq,Hkv,G,dh)  k,v: (B,Sk,Hkv,dh)  mask: (Sq,Sk) or (B,Sq,Sk).

    Masks with ``finfo(float32).min`` before the softmax, as the
    reference does, so a fully masked row comes out uniform (the kernels'
    −1e30 convention zeroes it instead; both are correct)."""
    B, Sq, Hkv, G, dh = q.shape
    scores = torch.einsum("bqhgd,bshd->bhgqs", q, k).float() * scale
    if mask.ndim == 2:
        mask = mask[None]
    neg = torch.finfo(torch.float32).min
    scores = scores.masked_fill(~mask[:, None, None], neg)
    apm = torch.softmax(scores, dim=-1)
    if memo is not None:
        memo_apm = memo.apm.reshape(B, Hkv, G, Sq, -1).float()
        apm = torch.where(memo.hit[:, None, None, None, None], memo_apm, apm)
    out = torch.einsum("bhgqs,bshd->bqhgd", apm.to(v.dtype), v)
    apm_full = apm.reshape(B, Hkv * G, Sq, -1) if return_apm else None
    return out, apm_full


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg, dtype=torch.float32, device=None):
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {"wq": dense_init(gen, (d, H, dh), scale=d ** -0.5, **kw),
         "wk": dense_init(gen, (d, Hkv, dh), scale=d ** -0.5, **kw),
         "wv": dense_init(gen, (d, Hkv, dh), scale=d ** -0.5, **kw),
         "wo": dense_init(gen, (H, dh, d), scale=(H * dh) ** -0.5, **kw)}
    if cfg.qkv_bias:
        p.update(bq=torch.zeros((H, dh), **kw),
                 bk=torch.zeros((Hkv, dh), **kw),
                 bv=torch.zeros((Hkv, dh), **kw))
    if cfg.qk_norm:
        p.update(q_norm=torch.ones((dh,), **kw),
                 k_norm=torch.ones((dh,), **kw))
    return p


def gqa_specs(cfg):
    s = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        s.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        s.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return s


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def _qkv(params, x, cfg, positions, use_rope=True):
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q, k = _rms(q, params["q_norm"]), _rms(k, params["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(params, x, cfg, *, positions, mask_kind="causal",
              window=None, memo: Optional[Memo] = None, return_apm=False,
              use_rope=True, attn_impl="plain", kpad=None):
    """Full-sequence GQA. x: (B,S,D) → (B,S,D).

    ``attn_impl="kernel"`` runs the ``flash_attention`` kernel wrapper
    when there is no memo, no APM capture and no ``kpad`` (the
    reference's gate for ``"pallas_interpret"``); otherwise ``_sdpa``.

    ``kpad``: optional (B, S) bool key-validity mask for padded
    variable-length batches — False keys are excluded from the softmax,
    so a sequence padded to a bucket length produces the same APM rows
    (and zero probability mass on pad columns) as its unpadded run."""
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(params, x, cfg, positions, use_rope)
    if attn_impl == "kernel" and memo is None and not return_apm \
            and kpad is None:
        out = flash_attention(q, k, v, causal=(mask_kind == "causal"),
                              window=window)
        apm = None
    else:
        qg = q.reshape(B, S, Hkv, H // Hkv, dh)
        mask = make_mask(S, S, mask_kind, window, device=x.device)
        if kpad is not None:
            mask = mask[None] & kpad[:, None, :]
        out, apm = _sdpa(qg, k, v, mask, dh ** -0.5, memo, return_apm)
        out = out.reshape(B, S, H, dh)
    y = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return y, apm


def gqa_decode(params, x, cfg, cache, pos, *, window=None, use_rope=True):
    """One-token decode. x: (B,1,D); cache: {'k','v'}: (B,Sc,Hkv,dh).
    ``pos``: the absolute position, a Python int or a 0-d integer tensor
    (a device tensor adds no host sync). Rolling buffer: writes at
    ``pos % Sc`` and masks each slot by the absolute position it holds
    (and the recency ``window``). Returns (y, new cache); the input
    cache is left as it was."""
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = x.device
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=dev)
    pos = pos.to(device=dev, dtype=torch.int64).reshape(())
    positions = pos.expand(B, 1)
    q, k, v = _qkv(params, x, cfg, positions, use_rope)
    Sc = cache["k"].shape[1]
    slot = torch.remainder(pos, Sc)
    ck = cache["k"].index_copy(1, slot.reshape(1), k.to(cache["k"].dtype))
    cv = cache["v"].index_copy(1, slot.reshape(1), v.to(cache["v"].dtype))
    # absolute position of each cache slot under rolling writes
    idx = torch.arange(Sc, device=dev)
    wrap = torch.div(pos, Sc, rounding_mode="floor") * Sc
    abs_pos = torch.where(idx <= slot, wrap + idx, wrap - Sc + idx)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    qg = q.reshape(B, 1, Hkv, H // Hkv, dh)
    out, _ = _sdpa(qg, ck, cv, valid[None, None, :], dh ** -0.5)
    out = out.reshape(B, 1, H, dh)
    y = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return y, {"k": ck, "v": cv}


def gqa_init_cache(cfg, batch, seq, dtype=torch.float32, device=None):
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    z = torch.zeros((batch, seq, Hkv, dh), dtype=dtype, device=device)
    return {"k": z, "v": z}


def gqa_prefill_cache(params, x, cfg, positions, seq_total, use_rope=True):
    """Build the decode cache from a full prompt (cheaper than
    re-decoding it): post-RoPE K and V, zero-padded to ``seq_total``."""
    _, k, v = _qkv(params, x, cfg, positions, use_rope)
    pad = seq_total - k.shape[1]
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return {"k": k, "v": v}


def gqa_apply_memo(params, x, cfg, apm):
    """Memo-only fast path: the APM is fully known, so Q/K projections,
    QKᵀ and softmax are all skipped — only V and the APM·V matmul run.
    x: (B,S,D); apm: (B,H,S,S) → (B,S,D)."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"])
    if cfg.qkv_bias:
        v = v + params["bv"]
    Hkv = cfg.n_kv_heads
    apm_g = apm.reshape(B, Hkv, H // Hkv, S, S).to(v.dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", apm_g, v).reshape(B, S, H, dh)
    return torch.einsum("bshe,hed->bsd", out, params["wo"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg, dtype=torch.float32, device=None):
    d, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "w_dq": dense_init(gen, (d, m.q_lora_rank), **kw),
        "q_norm": torch.ones((m.q_lora_rank,), **kw),
        "w_uq": dense_init(gen, (m.q_lora_rank, H, qk),
                           scale=m.q_lora_rank ** -0.5, **kw),
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank), **kw),
        "kv_norm": torch.ones((m.kv_lora_rank,), **kw),
        "w_kr": dense_init(gen, (d, m.qk_rope_head_dim), **kw),
        "w_uk": dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim),
                           scale=m.kv_lora_rank ** -0.5, **kw),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim),
                           scale=m.kv_lora_rank ** -0.5, **kw),
        "wo": dense_init(gen, (H, m.v_head_dim, d),
                         scale=(H * m.v_head_dim) ** -0.5, **kw),
    }


def mla_specs(cfg):
    return {"w_dq": ("embed", "q_lora"), "q_norm": ("q_lora",),
            "w_uq": ("q_lora", "heads", "head_dim"),
            "w_dkv": ("embed", "kv_lora"), "kv_norm": ("kv_lora",),
            "w_kr": ("embed", "head_dim"),
            "w_uk": ("kv_lora", "heads", "head_dim"),
            "w_uv": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


def _mla_qkr(params, x, cfg, positions):
    m = cfg.mla
    cq = _rms(x @ params["w_dq"], params["q_norm"])
    q = torch.einsum("bsr,rhe->bshe", cq, params["w_uq"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    c_kv = _rms(x @ params["w_dkv"], params["kv_norm"])
    k_rope = apply_rope(x @ params["w_kr"], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(params, x, cfg, *, positions, mask_kind="causal", window=None,
              memo: Optional[Memo] = None, return_apm=False,
              attn_impl="plain", kpad=None):
    """Full-sequence MLA. x: (B,S,D) → (B,S,D). Scores are the nope part
    through the expanded keys plus the shared rope key, masked with
    ``finfo(float32).min`` as in ``_sdpa``. ``attn_impl`` is accepted and
    ignored, as in the reference: MLA reaches no attention kernel."""
    B, S, _ = x.shape
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(params, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uv"])
    scores = (torch.einsum("bqhe,bshe->bhqs", q_nope, k_nope)
              + torch.einsum("bqhe,bse->bhqs", q_rope, k_rope))
    scores = scores.float() * scale
    mask = make_mask(S, S, mask_kind, window, device=x.device)
    if kpad is not None:
        mask = mask[None] & kpad[:, None, :]
    mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    apm = torch.softmax(scores, dim=-1)
    if memo is not None:
        apm = torch.where(memo.hit[:, None, None, None], memo.apm.float(),
                          apm)
    out = torch.einsum("bhqs,bshe->bqhe", apm.to(v.dtype), v)
    y = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return y, (apm if return_apm else None)


def mla_apply_memo(params, x, cfg, apm):
    """Memo-only MLA fast path: skip the q path, QKᵀ and softmax; compute
    the compressed kv and expand V only. x: (B,S,D); apm: (B,H,S,S)."""
    c_kv = _rms(x @ params["w_dkv"], params["kv_norm"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uv"])
    out = torch.einsum("bhqs,bshe->bqhe", apm.to(v.dtype), v)
    return torch.einsum("bshe,hed->bsd", out, params["wo"])


def mla_decode(params, x, cfg, cache, pos, *, window=None):
    """Absorbed-matmul MLA decode: attention runs in the kv_lora latent
    space and the cache holds (c_kv, k_rope) only. x: (B,1,D); ``pos`` as
    in ``gqa_decode`` (a ring of ``Sc`` slots, each masked by the absolute
    position it holds and the recency ``window``). Returns (y, new
    cache); the input cache is left as it was."""
    B = x.shape[0]
    m = cfg.mla
    dev = x.device
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=dev)
    pos = pos.to(device=dev, dtype=torch.int64).reshape(())
    positions = pos.expand(B, 1)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkr(params, x, cfg,
                                                    positions)
    Sc = cache["c_kv"].shape[1]
    slot = torch.remainder(pos, Sc).reshape(1)
    c_kv = cache["c_kv"].index_copy(1, slot,
                                    c_kv_new.to(cache["c_kv"].dtype))
    k_rope = cache["k_rope"].index_copy(1, slot,
                                        k_rope_new.to(cache["k_rope"].dtype))
    idx = torch.arange(Sc, device=dev)
    wrap = torch.div(pos, Sc, rounding_mode="floor") * Sc
    abs_pos = torch.where(idx <= slot, wrap + idx, wrap - Sc + idx)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    # absorbed: q ⋅ W_uk projected into latent space once per step
    q_abs = torch.einsum("bqhe,rhe->bqhr", q_nope, params["w_uk"])
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, c_kv)
              + torch.einsum("bqhe,bse->bhqs", q_rope, k_rope))
    scores = scores.float() * scale
    scores = scores.masked_fill(~valid[None, None, None],
                                torch.finfo(torch.float32).min)
    apm = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqs,bsr->bqhr", apm, c_kv)
    out = torch.einsum("bqhr,rhe->bqhe", ctx, params["w_uv"])
    y = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_init_cache(cfg, batch, seq, dtype=torch.float32, device=None):
    m = cfg.mla
    kw = dict(dtype=dtype, device=device)
    return {"c_kv": torch.zeros((batch, seq, m.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, seq, m.qk_rope_head_dim), **kw)}


def mla_prefill_cache(params, x, cfg, positions, seq_total):
    """The decode cache from a full prompt: the normed latent ``c_kv``
    and the post-RoPE ``k_rope``, zero-padded to ``seq_total``."""
    _, _, c_kv, k_rope = _mla_qkr(params, x, cfg, positions)
    pad = seq_total - c_kv.shape[1]
    if pad > 0:
        c_kv = F.pad(c_kv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
    return {"c_kv": c_kv, "k_rope": k_rope}
