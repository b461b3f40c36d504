"""Whisper-style encoder-decoder backbone (conv/mel frontend stubbed), the
counterpart of the reference's ``models/encdec.py``.

The encoder consumes precomputed frame embeddings (B, n_frames, d_enc).
Decoder: causal self-attention + cross-attention + MLP, pre-LayerNorm,
learned absolute positions (no RoPE), as in Whisper. Encoder
self-attention APMs are the AttMemo target.

The encoder and decoder layers are stacked on a leading axis, as the
reference's ``vmap`` stacks them, so the bridge carries the trees across
unchanged; PyTorch runs eagerly, so each stack is a Python loop (the
reference's ``layer_loop="unroll"``). ``attn_impl="kernel"`` runs the
``flash_attention`` wrapper in the encoder (bidirectional) and in the
decoder's self-attention over the prompt (causal); cross-attention stays
plain softmax, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.backbone import _stacked, _tree_index, _tree_stack
from repro_torch.models.layers import (
    dense_init, embed_init, mlp_apply, mlp_init, mlp_specs, norm_apply,
    norm_init, norm_specs,
)
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------

def cross_init(gen, d, d_kv, n_heads, dh, dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    return {"wq": dense_init(gen, (d, n_heads, dh), scale=d ** -0.5, **kw),
            "wk": dense_init(gen, (d_kv, n_heads, dh), scale=d_kv ** -0.5,
                             **kw),
            "wv": dense_init(gen, (d_kv, n_heads, dh), scale=d_kv ** -0.5,
                             **kw),
            "wo": dense_init(gen, (n_heads, dh, d),
                             scale=(n_heads * dh) ** -0.5, **kw)}


def cross_specs():
    return {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "heads", "head_dim"),
            "wv": ("embed", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


def cross_kv(params, enc_h):
    k = torch.einsum("bsd,dhe->bshe", enc_h, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", enc_h, params["wv"])
    return {"ck": k, "cv": v}


def cross_apply(params, x, kv):
    """Plain softmax over every frame, scores in f32."""
    dh = params["wq"].shape[2]
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    scores = torch.einsum("bqhe,bshe->bhqs", q, kv["ck"]).float()
    apm = torch.softmax(scores * dh ** -0.5, -1)
    out = torch.einsum("bhqs,bshe->bqhe", apm.to(x.dtype), kv["cv"])
    return torch.einsum("bshe,hed->bsd", out, params["wo"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def encoder_cfg(cfg):
    """The encoder's view of ``cfg``: its width and heads, MHA, no QKV
    bias or qk-norm (the reference's ``ecfg``)."""
    e = cfg.encoder
    return cfg.replace(d_model=e.d_model, n_heads=e.n_heads,
                       n_kv_heads=e.n_heads, d_head=e.d_model // e.n_heads,
                       qkv_bias=False, qk_norm=False)


def encdec_init(gen, cfg, max_seq=4096, dtype=torch.float32, device=None):
    """Random params from ``gen`` → (params, ecfg)."""
    e = cfg.encoder
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    ecfg = encoder_cfg(cfg)

    def normal(shape):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return (out.normal_(0.0, 1.0, generator=gen) * 0.02).to(dtype)

    def enc_layer(_):
        return {"norm1": norm_init(e.d_model, cfg.norm, **kw),
                "attn": attn.gqa_init(gen, ecfg, **kw),
                "norm2": norm_init(e.d_model, cfg.norm, **kw),
                "mlp": mlp_init(gen, e.d_model, e.d_ff, cfg.glu, **kw)}

    def dec_layer(_):
        return {"norm1": norm_init(d, cfg.norm, **kw),
                "attn": attn.gqa_init(gen, cfg, **kw),
                "norm_x": norm_init(d, cfg.norm, **kw),
                "cross": cross_init(gen, d, e.d_model, cfg.n_heads,
                                    cfg.head_dim, **kw),
                "norm2": norm_init(d, cfg.norm, **kw),
                "mlp": mlp_init(gen, d, cfg.d_ff, cfg.glu, **kw)}

    return {
        "enc_pos": normal((e.n_frames, e.d_model)),
        "enc_layers": _stacked(enc_layer, e.n_layers),
        "enc_norm": norm_init(e.d_model, cfg.norm, **kw),
        "embed": embed_init(gen, cfg.vocab, d, **kw),
        "dec_pos": normal((max_seq, d)),
        "dec_layers": _stacked(dec_layer, cfg.n_layers),
        "final_norm": norm_init(d, cfg.norm, **kw),
    }, ecfg


def encdec_specs(cfg):
    """Logical-axis names mirroring ``encdec_init``'s tree; the stacked
    layers lead with ``"layers"``."""
    def stacked(group):
        return tree_map(lambda t: ("layers",) + t, group)
    enc = {"norm1": norm_specs(cfg.norm),
           "attn": attn.gqa_specs(cfg.replace(qkv_bias=False,
                                              qk_norm=False)),
           "norm2": norm_specs(cfg.norm),
           "mlp": mlp_specs(cfg.glu)}
    dec = {"norm1": norm_specs(cfg.norm),
           "attn": attn.gqa_specs(cfg),
           "norm_x": norm_specs(cfg.norm),
           "cross": cross_specs(),
           "norm2": norm_specs(cfg.norm),
           "mlp": mlp_specs(cfg.glu)}
    return {"enc_pos": ("frames", "embed"), "enc_layers": stacked(enc),
            "enc_norm": norm_specs(cfg.norm), "embed": ("vocab", "embed"),
            "dec_pos": ("seq", "embed"), "dec_layers": stacked(dec),
            "final_norm": norm_specs(cfg.norm)}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def enc_layer_apply(lp, h, cfg, ecfg, positions, *, memo=None,
                    return_apm=False, attn_impl="plain"):
    """One encoder layer (bidirectional, no RoPE). Returns (h, apm)."""
    x = norm_apply(lp["norm1"], h, cfg.norm)
    y, apm = attn.gqa_apply(lp["attn"], x, ecfg, positions=positions,
                            mask_kind="bidir", memo=memo,
                            return_apm=return_apm, use_rope=False,
                            attn_impl=attn_impl)
    h = h + y
    x = norm_apply(lp["norm2"], h, cfg.norm)
    return h + mlp_apply(lp["mlp"], x, cfg.act, cfg.glu), apm


def enc_embed(params, frames):
    """Stub frame embeddings plus the learned positions."""
    S = frames.shape[1]
    return frames.to(params["enc_pos"].dtype) + params["enc_pos"][None, :S]


def encode(params, frames, cfg, ecfg, *, capture=False, memo_plan=None,
           attn_impl="plain"):
    """frames: (B, n_frames, d_enc) stub embeddings → (enc_h, apms), apms
    ``{li: {"apm", "hidden"}}`` under ``capture`` (the reference's
    ``layer_loop="unroll"`` branch)."""
    h = enc_embed(params, frames)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    apms: Dict[int, Any] = {}
    for li in range(cfg.encoder.n_layers):
        lp = _tree_index(params["enc_layers"], li)
        memo = memo_plan.get(li) if memo_plan else None
        x_in = norm_apply(lp["norm1"], h, cfg.norm)
        h, apm = enc_layer_apply(lp, h, cfg, ecfg, positions, memo=memo,
                                 return_apm=capture, attn_impl=attn_impl)
        if apm is not None:
            apms[li] = {"apm": apm, "hidden": x_in}
    return norm_apply(params["enc_norm"], h, cfg.norm), apms


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def dec_layer_apply(lp, h, cfg, kv, *, mode, positions, pos, cache,
                    window=None, attn_impl="plain"):
    """One decoder layer; ``mode`` "full", "prefill" (builds the layer's
    self-attention cache from ``cache``'s template) or "decode" (one
    token at ``pos``). Returns (h, {"sa", "kv"} or None in "full")."""
    x = norm_apply(lp["norm1"], h, cfg.norm)
    if mode == "decode":
        y, cache_sa = attn.gqa_decode(lp["attn"], x, cfg, cache["sa"], pos,
                                      window=window, use_rope=False)
    else:
        y, _ = attn.gqa_apply(lp["attn"], x, cfg, positions=positions,
                              mask_kind="causal", window=window,
                              use_rope=False, attn_impl=attn_impl)
        cache_sa = (attn.gqa_prefill_cache(
            lp["attn"], x, cfg, positions, cache["sa"]["k"].shape[1],
            use_rope=False) if mode == "prefill" else None)
    h = h + y
    x = norm_apply(lp["norm_x"], h, cfg.norm)
    h = h + cross_apply(lp["cross"], x, kv)
    x = norm_apply(lp["norm2"], h, cfg.norm)
    h = h + mlp_apply(lp["mlp"], x, cfg.act, cfg.glu)
    new_cache = {"sa": cache_sa, "kv": kv} if mode != "full" else None
    return h, new_cache


def _dec_layer_body(lp, h, cfg, enc_h, **kw):
    """``dec_layer_apply`` on the layer's cross K/V of ``enc_h`` (the
    reference's scan body)."""
    return dec_layer_apply(lp, h, cfg, cross_kv(lp["cross"], enc_h), **kw)


def decode_tokens(params, tokens, enc_h, cfg, *, mode="full", caches=None,
                  pos=None, window=None, attn_impl="plain", remat=False):
    """tokens: (B,S) ids. enc_h: (B,F,d_enc), or None in "decode" mode
    (the caches hold each layer's cross K/V). Returns (h, new caches,
    stacked on the layer axis; None in "full"). With ``remat`` each
    layer outside "decode" runs under activation checkpointing (the
    reference's ``jax.checkpoint`` of its scan body)."""
    B, S = tokens.shape
    dec_pos = params["dec_pos"]
    positions = None
    if mode == "decode":
        # the reference clamps the position to the table's last row
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), int(pos), dtype=torch.int64,
                             device=dec_pos.device)
        pidx = torch.clamp(pos.to(device=dec_pos.device,
                                  dtype=torch.int64).reshape(1),
                           max=dec_pos.shape[0] - 1)
        pos_emb = dec_pos.index_select(0, pidx)[None]
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        pos_emb = dec_pos[None, :S]
    h = params["embed"][tokens.long()] + pos_emb
    apply = dec_layer_apply if mode == "decode" else _dec_layer_body
    if remat and mode != "decode":
        apply = functools.partial(checkpoint, apply, use_reentrant=False)
    out = []
    for li in range(cfg.n_layers):
        lp = _tree_index(params["dec_layers"], li)
        gc = None if caches is None else _tree_index(caches, li)
        kv = gc["kv"] if mode == "decode" else enc_h
        h, c = apply(lp, h, cfg, kv, mode=mode, positions=positions,
                     pos=pos, cache=gc, window=window, attn_impl=attn_impl)
        out.append(c)
    return h, (None if mode == "full" else _tree_stack(out))


def encdec_init_caches(cfg, batch, seq, dtype=torch.float32, device=None):
    e = cfg.encoder
    L, Hkv, dh, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "sa": {"k": torch.zeros((L, batch, seq, Hkv, dh), **kw),
               "v": torch.zeros((L, batch, seq, Hkv, dh), **kw)},
        "kv": {"ck": torch.zeros((L, batch, e.n_frames, H, dh), **kw),
               "cv": torch.zeros((L, batch, e.n_frames, H, dh), **kw)},
    }
