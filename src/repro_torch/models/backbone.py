"""Backbone: assembles mixers (GQA or MLA attention, rwkv6, RG-LRU) and
channel mixers (MLP, MoE, rwkv6's) into a model (the reference's
``models/backbone.py``).

The parameter tree keeps the reference's layout, so the bridge from JAX
weights is a name map: ``params["layers"]["seg{i}"]["l{u}"]`` holds one
segment of ``scan_plan``, and a ``scan`` segment stacks its repeats on a
leading axis. PyTorch runs eagerly, so every segment is a Python loop
(the reference's ``layer_loop="unroll"``): per-layer APM capture and
memo overrides work everywhere. Caches (``init_caches``) keep the
reference's layout too, so prefill and decode caches compare leaf for
leaf across the packages. A hybrid (recurrentgemma's (rglru, rglru,
attn) pattern) is one ``scan`` segment of the whole unit, its repeats
stacked, and single segments for the layers past the last whole unit.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (
    dense_init, embed_init, mlp_apply, mlp_init, mlp_specs, norm_apply,
    norm_init, norm_specs,
)
from repro_torch.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# segment plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Segment:
    kind: str            # "single" | "scan"
    start: int           # first layer index
    unit: Tuple[str, ...]  # mixer kinds inside one step
    reps: int            # scan repeats (1 for single)


def scan_plan(cfg) -> List[Segment]:
    kinds = cfg.layer_kinds()
    n = cfg.n_layers
    segs: List[Segment] = []
    start = cfg.dense_first_n
    for i in range(start):
        segs.append(Segment("single", i, (kinds[i],), 1))
    unit = len(cfg.layer_pattern) if cfg.layer_pattern != ("mix",) else 1
    reps = (n - start) // unit
    if reps > 0:
        segs.append(Segment("scan", start, tuple(kinds[start:start + unit]),
                            reps))
    for i in range(start + reps * unit, n):
        segs.append(Segment("single", i, (kinds[i],), 1))
    return segs


def _chan_kind(cfg, layer_idx: int) -> str:
    if cfg.layer_kinds()[layer_idx] == "rwkv6":
        return "rwkvc"
    if cfg.moe is not None and layer_idx >= cfg.dense_first_n:
        return "moe"
    return "mlp"


def _dense_ff(cfg, layer_idx: int) -> int:
    if (cfg.moe is not None and layer_idx < cfg.dense_first_n
            and cfg.dense_d_ff):
        return cfg.dense_d_ff
    return cfg.d_ff


# ---------------------------------------------------------------------------
# per-layer init / specs / apply
# ---------------------------------------------------------------------------

_MIX_INIT = {"attn": attn.gqa_init, "mla": attn.mla_init,
             "rwkv6": rwkv_mod.rwkv_time_init, "rglru": rglru_mod.rglru_init}
_MIX_SPECS = {"attn": attn.gqa_specs, "mla": attn.mla_specs,
              "rwkv6": rwkv_mod.rwkv_time_specs,
              "rglru": rglru_mod.rglru_specs}


def _layer_init(gen, cfg, layer_idx, kind, dtype, device):
    d = cfg.d_model
    p = {"norm1": norm_init(d, cfg.norm, dtype, device),
         "norm2": norm_init(d, cfg.norm, dtype, device),
         "mix": _MIX_INIT[kind](gen, cfg, dtype, device)}
    ck = _chan_kind(cfg, layer_idx)
    if ck == "rwkvc":
        p["chan"] = rwkv_mod.rwkv_channel_init(gen, cfg, dtype, device)
    elif ck == "moe":
        p["chan"] = moe_mod.moe_init(gen, cfg, dtype, device)
    else:
        p["chan"] = mlp_init(gen, d, _dense_ff(cfg, layer_idx), cfg.glu,
                             dtype, device)
    return p


def _layer_specs(cfg, layer_idx, kind):
    s = {"norm1": norm_specs(cfg.norm), "norm2": norm_specs(cfg.norm),
         "mix": _MIX_SPECS[kind](cfg)}
    ck = _chan_kind(cfg, layer_idx)
    if ck == "rwkvc":
        s["chan"] = rwkv_mod.rwkv_channel_specs(cfg)
    elif ck == "moe":
        s["chan"] = moe_mod.moe_specs(cfg)
    else:
        s["chan"] = mlp_specs(cfg.glu)
    return s


def _layer_apply(lp, h, cfg, kind, layer_idx, *, mode, positions,
                 pos=None, cache=None, memo=None, capture=False,
                 mesh=None, dp_axes=("data",), window=None,
                 attn_impl="plain", kpad=None):
    """Returns (h, new_cache, apm, aux) — ``apm`` is ``{"apm",
    "hidden"}`` under capture, ``aux`` the MoE router's load-balance loss
    (0 for other channel mixers). ``mode``: "full" (no cache), "prefill"
    (the prompt, building the layer's decode cache or recurrent state
    from ``cache``'s template) or "decode" (one token at absolute
    position ``pos``). ``mesh`` reaches the MoE layer (its
    expert-parallel form); every other layer runs where ``h`` is. The
    reference's ``cfg.act_shard_batch`` (a batch-sharding constraint on
    the activations, a placement that changes no value) is not acted
    on: one controller places nothing but the experts."""
    mask_kind = "causal" if cfg.causal else "bidir"
    x = norm_apply(lp["norm1"], h, cfg.norm)
    apm = None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "attn":
        win = cfg.sliding_window if cfg.sliding_window else window
        if mode == "decode":
            y, cache = attn.gqa_decode(lp["mix"], x, cfg, cache, pos,
                                       window=win)
        else:
            y, apm = attn.gqa_apply(
                lp["mix"], x, cfg, positions=positions, mask_kind=mask_kind,
                window=win, memo=memo, return_apm=capture,
                attn_impl=attn_impl, kpad=kpad)
            if mode == "prefill":
                cache = attn.gqa_prefill_cache(
                    lp["mix"], x, cfg, positions, cache_len_from(cache))
    elif kind == "mla":
        if mode == "decode":
            y, cache = attn.mla_decode(lp["mix"], x, cfg, cache, pos,
                                       window=window)
        else:
            y, apm = attn.mla_apply(
                lp["mix"], x, cfg, positions=positions, mask_kind=mask_kind,
                window=window, memo=memo, return_apm=capture,
                attn_impl=attn_impl, kpad=kpad)
            if mode == "prefill":
                cache = attn.mla_prefill_cache(
                    lp["mix"], x, cfg, positions, cache_len_from(cache))
    elif kind == "rwkv6":
        # the wkv kernel starts from a zero state: prefill and decode
        # carry a state, so they take the scan
        y, cache_t = rwkv_mod.rwkv_time_apply(
            lp["mix"], x, cfg,
            None if mode == "full" else cache and cache.get("time"),
            impl="kernel" if attn_impl == "kernel" and mode == "full"
            else "scan")
        cache = dict(cache or {}, time=cache_t)
    elif kind == "rglru":
        y, cache_r = rglru_mod.rglru_apply(
            lp["mix"], x, cfg,
            None if mode == "full" else cache and cache.get("rec"))
        cache = dict(cache or {}, rec=cache_r)
    else:
        raise ValueError(kind)
    if apm is not None:
        # AttMemo capture: the memo key is the attention input hidden state
        apm = {"apm": apm, "hidden": x}
    h = h + y
    x = norm_apply(lp["norm2"], h, cfg.norm)
    ck = _chan_kind(cfg, layer_idx)
    if ck == "rwkvc":
        y, cache_c = rwkv_mod.rwkv_channel_apply(
            lp["chan"], x, cfg,
            None if mode == "full" else cache and cache.get("chan"))
        cache = dict(cache or {}, chan=cache_c)
    elif ck == "moe":
        y, aux = moe_mod.moe_apply(lp["chan"], x, cfg, mesh=mesh,
                                   dp_axes=dp_axes)
    else:
        y = mlp_apply(lp["chan"], x, cfg.act, cfg.glu)
    return h + y, cache, apm, aux


def cache_len_from(cache) -> int:
    """Total cache slots from a cache template (prefill pads up to this)."""
    if cache is None:
        return 0
    for v in leaves(cache):
        return v.shape[1]
    return 0


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def layer_cache(cfg, kind, layer_idx, batch, seq, dtype, device=None):
    if kind == "attn":
        return attn.gqa_init_cache(cfg, batch, seq, dtype, device)
    if kind == "mla":
        return attn.mla_init_cache(cfg, batch, seq, dtype, device)
    if kind == "rwkv6":
        return {"time": rwkv_mod.rwkv_time_init_state(cfg, batch, dtype,
                                                      device),
                "chan": rwkv_mod.rwkv_channel_init_state(cfg, batch, dtype,
                                                         device)}
    if kind == "rglru":
        return {"rec": rglru_mod.rglru_init_state(cfg, batch, dtype, device)}
    raise ValueError(kind)


def init_caches(cfg, batch, seq, dtype=torch.float32, window=None,
                device=None):
    """Caches per segment, in the reference's layout (a scan segment
    stacks its repeats on a leading axis). Attention caches are sized
    min(seq, window); recurrent states (rwkv6, RG-LRU) do not depend on
    ``seq``."""
    caches = {}
    attn_len = min(seq, window) if window else seq
    for si, seg in enumerate(scan_plan(cfg)):
        def one(kind, idx):
            s = attn_len if kind in ("attn", "mla") else seq
            if kind == "attn" and cfg.sliding_window:
                s = min(seq, cfg.sliding_window)
            return layer_cache(cfg, kind, idx, batch, s, dtype, device)
        group = {f"l{u}": one(kind, seg.start + u)
                 for u, kind in enumerate(seg.unit)}
        if seg.kind == "scan":
            group = tree_map(
                lambda a: a.expand((seg.reps,) + tuple(a.shape)), group)
        caches[f"seg{si}"] = group
    return caches


# ---------------------------------------------------------------------------
# backbone init / specs
# ---------------------------------------------------------------------------

def backbone_init(gen, cfg, dtype=torch.float32, device=None):
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                  dtype=dtype, device=device)
    if cfg.n_classes:
        p["cls"] = dense_init(gen, (cfg.d_model, cfg.n_classes),
                              dtype=dtype, device=device)
    layers = {}
    for si, seg in enumerate(scan_plan(cfg)):
        def group_init(rep):
            return {f"l{u}": _layer_init(
                gen, cfg, seg.start + rep * len(seg.unit) + u, kind, dtype,
                device) for u, kind in enumerate(seg.unit)}
        if seg.kind == "single":
            layers[f"seg{si}"] = group_init(0)
        else:
            layers[f"seg{si}"] = _stacked(group_init, seg.reps)
    p["layers"] = layers
    return p


def backbone_specs(cfg):
    """Logical-axis names mirroring ``backbone_init``'s tree; a scan
    segment's stacked leaves lead with ``"layers"``."""
    s: Dict[str, Any] = {"embed": ("vocab", "embed"),
                         "final_norm": norm_specs(cfg.norm)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("embed", "vocab")
    if cfg.n_classes:
        s["cls"] = ("embed", None)
    layers = {}
    for si, seg in enumerate(scan_plan(cfg)):
        group = {f"l{u}": _layer_specs(cfg, seg.start + u, kind)
                 for u, kind in enumerate(seg.unit)}
        if seg.kind == "scan":
            group = tree_map(lambda t: ("layers",) + t, group)
        layers[f"seg{si}"] = group
    s["layers"] = layers
    return s


def _stacked(make, reps):
    """``_tree_stack([make(r) for r in range(reps)])`` without holding
    every repeat at once: each is copied into the stacked tree as it is
    made, so the peak is the stack plus one repeat (dbrx_132b's layers
    are 13 GB each in f32)."""
    out = None
    for r in range(reps):
        tree = make(r)
        if out is None:
            out = tree_map(
                lambda a: a.new_empty((reps,) + tuple(a.shape)), tree)
        _copy_rep(out, tree, r)
        del tree
    return out


def _copy_rep(out, tree, r):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_rep(out[k], v, r)
    elif tree is not None:
        out[r].copy_(tree)


def _tree_stack(trees):
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _tree_index(tree, r):
    return tree_map(lambda a: a[r], tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg):
    """tokens: int ids (B,S) or precomputed embeddings (B,S,D)."""
    if tokens.ndim == 3:
        return tokens.to(params["embed"].dtype)
    return params["embed"][tokens.long()]


def iter_layers(params, cfg):
    """Yield (layer_idx, kind, layer_params) in depth order; a scan
    segment's repeats are views into the stacked tensors."""
    for si, seg in enumerate(scan_plan(cfg)):
        sp = params["layers"][f"seg{si}"]
        if seg.kind == "single":
            for u, kind in enumerate(seg.unit):
                yield seg.start + u, kind, sp[f"l{u}"]
        else:
            for r in range(seg.reps):
                gp = _tree_index(sp, r)
                for u, kind in enumerate(seg.unit):
                    yield (seg.start + r * len(seg.unit) + u, kind,
                           gp[f"l{u}"])


def _tree_unbind(tree, n):
    """The ``n`` repeats of a stacked tree as views, one ``unbind`` a
    leaf (whose backward stacks the repeats' grads once, where indexing
    each repeat would scatter each into a zero copy of the stack)."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        parts = {k: _tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    return list(torch.unbind(tree))


def forward_hidden(params, h, cfg, *, mode="full", positions=None,
                   pos=None, caches=None, memo_plan=None, capture=False,
                   mesh=None, dp_axes=("data",), window=None,
                   attn_impl="plain", remat=False):
    """Run all layers. Returns (h, new_caches, apms{layer_idx: apm},
    aux): ``new_caches`` has ``caches``' layout (None per segment in
    "full" mode), ``aux`` the summed MoE router losses. ``mesh`` and
    ``dp_axes`` reach every MoE layer (``moe_apply_ep``). With ``remat``
    each layer of a "full" pass runs under activation checkpointing
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
    its scan body): its activations are recomputed in the backward
    pass instead of kept."""
    apms: Dict[int, Any] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    new_caches = {}
    if positions is None and mode != "decode":
        B, S = h.shape[0], h.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device).expand(B, S)
    apply = _layer_apply
    if remat and mode == "full":
        apply = functools.partial(checkpoint, _layer_apply,
                                  use_reentrant=False)
    for si, seg in enumerate(scan_plan(cfg)):
        sp = params["layers"][f"seg{si}"]
        sc = caches.get(f"seg{si}") if caches else None
        if seg.kind == "single":
            gps, gcs = [sp], [sc]
        else:
            gps, gcs = _tree_unbind(sp, seg.reps), _tree_unbind(sc, seg.reps)
        reps = []
        for r, (gp, gc) in enumerate(zip(gps, gcs)):
            out = {}
            for u, kind in enumerate(seg.unit):
                li = seg.start + r * len(seg.unit) + u
                memo = memo_plan.get(li) if memo_plan else None
                h, c, apm, aux = apply(
                    gp[f"l{u}"], h, cfg, kind, li, mode=mode,
                    positions=positions, pos=pos,
                    cache=gc.get(f"l{u}") if gc else None, memo=memo,
                    capture=capture and kind in ("attn", "mla"),
                    mesh=mesh, dp_axes=dp_axes, window=window,
                    attn_impl=attn_impl)
                out[f"l{u}"] = c
                aux_total = aux_total + aux
                if apm is not None:
                    apms[li] = apm
            reps.append(out)
        if mode == "full":
            new_caches[f"seg{si}"] = None
        elif seg.kind == "single":
            new_caches[f"seg{si}"] = reps[0]
        else:
            new_caches[f"seg{si}"] = _tree_stack(reps)
    return h, new_caches, apms, aux_total


def logits_from_hidden(params, h, cfg):
    h = norm_apply(params["final_norm"], h, cfg.norm)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def classify_from_hidden(params, h, cfg, kpad: Optional[torch.Tensor] = None):
    """``kpad``: optional (B, S) bool validity mask — padded positions are
    excluded from the mean pool so a padded variable-length batch scores
    each sequence exactly like its unpadded run."""
    h = norm_apply(params["final_norm"], h, cfg.norm)
    if kpad is None:
        pooled = torch.mean(h, dim=1)
    else:
        m = kpad.to(h.dtype)[:, :, None]
        pooled = torch.sum(h * m, dim=1) / torch.clamp(
            torch.sum(m, dim=1), min=1.0)
    return pooled @ params["cls"]
