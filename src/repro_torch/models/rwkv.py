"""RWKV-6 "Finch" mixer — attention-free, data-dependent decay (the
reference's ``models/rwkv.py``).

[arXiv:2404.05892]. Per head (dim N): state S ∈ R^{N×N},
    o_t = (S_t + diag(u)·k_tᵀv_t)ᵀ r_t,    S_{t+1} = diag(w_t)·S_t + k_tᵀ v_t
with per-channel decay w_t = exp(-exp(w0 + lora_w(x̃_t))) ∈ (0,1) and
ddlerp token-shift mixing (low-rank data-dependent interpolation with the
previous token). Output gating g and per-head GroupNorm as in the paper.

``rwkv_time_apply(impl=...)``: ``"scan"`` runs ``_wkv_scan`` (the
reference's ``"scan"``), ``"kernel"`` runs the ``rwkv6`` kernel wrapper
(the reference's ``"pallas_interpret"``) on fresh-state sequences: the
kernel starts from a zero state and returns no final state, so a call
with a ``state`` (prefill and decode) always takes the scan, as the
reference's does. The reference's ``cfg.act_shard_batch`` pins the
scan's operands to a batch sharding over the mesh, a placement that
changes no value; the port's one controller does not act on it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv_scan as _wkv_scan
from repro_torch.models.layers import dense_init

_LORA = 64          # ddlerp / decay low-rank dim


def rwkv_time_init(gen, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    nh = d // cfg.rwkv_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "mu_x": torch.full((d,), 0.5, **kw),
        # one fused ddlerp lora: d -> 5*_LORA -> 5*d
        "ddlerp_a": dense_init(gen, (d, 5 * _LORA), **kw),
        "ddlerp_b": dense_init(gen, (5, _LORA, d), scale=_LORA ** -0.5, **kw),
        "mu": torch.full((5, d), 0.5, **kw),            # per-proj base mix
        "w0": torch.full((d,), -6.0, **kw),             # decay bias (slow)
        "decay_a": dense_init(gen, (d, _LORA), **kw),
        "decay_b": dense_init(gen, (_LORA, d), scale=_LORA ** -0.5, **kw),
        "u": torch.zeros((d,), **kw),                   # bonus
        "wr": dense_init(gen, (d, d), **kw),
        "wk": dense_init(gen, (d, d), **kw),
        "wv": dense_init(gen, (d, d), **kw),
        "wg": dense_init(gen, (d, d), **kw),
        "wo": dense_init(gen, (d, d), **kw),
        "ln_scale": torch.ones((nh, cfg.rwkv_head_dim), **kw),
    }


def _shift(x, state=None):
    """The previous token of each position: zeros before the first, or
    the state's last token (``state["x_prev"]``) when there is one."""
    if state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([state["x_prev"][:, None], x[:, :-1]], 1)


def rwkv_time_specs(cfg):
    return {"mu_x": ("embed",), "ddlerp_a": ("embed", "lora"),
            "ddlerp_b": ("proj5", "lora", "embed"), "mu": ("proj5", "embed"),
            "w0": ("embed",), "decay_a": ("embed", "lora"),
            "decay_b": ("lora", "embed"), "u": ("embed",),
            "wr": ("embed", "heads_embed"), "wk": ("embed", "heads_embed"),
            "wv": ("embed", "heads_embed"), "wg": ("embed", "heads_embed"),
            "wo": ("heads_embed", "embed"),
            "ln_scale": ("heads", "head_dim")}


def _ddlerp(params, x, x_prev):
    """Returns the 5 mixed inputs (r,k,v,w,g) stacked: (B,S,5,D)."""
    xx = x_prev - x
    xxx = x + xx * params["mu_x"]
    a = torch.tanh(xxx @ params["ddlerp_a"])               # (B,S,5*LORA)
    B, S, _ = a.shape
    a = a.reshape(B, S, 5, _LORA)
    lora = torch.einsum("bspl,pld->bspd", a, params["ddlerp_b"])
    mix = params["mu"][None, None] + lora                  # (B,S,5,D)
    return x[:, :, None] + xx[:, :, None] * mix


def _groupnorm(x, scale, eps=1e-5):
    """x: (B,S,nh,N) — normalize per head."""
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rwkv_time_apply(params, x, cfg, state=None, impl="scan"):
    """Full-sequence time-mix. x: (B,S,D). state: {'s','x_prev'} or None
    (a fresh sequence). ``impl="kernel"`` runs the wkv kernel on fresh
    sequences only. Returns (y, new_state)."""
    if impl not in ("scan", "kernel"):
        raise ValueError(f"impl must be 'scan' or 'kernel', got {impl!r}")
    B, S, d = x.shape
    nh, N = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    mixed = _ddlerp(params, x, _shift(x, state))            # (B,S,5,D)
    xr, xk, xv, xw, xg = mixed.unbind(2)
    r = (xr @ params["wr"]).reshape(B, S, nh, N)
    k = (xk @ params["wk"]).reshape(B, S, nh, N)
    v = (xv @ params["wv"]).reshape(B, S, nh, N)
    g = F.silu(xg @ params["wg"])
    dec = params["w0"] + torch.tanh(xw @ params["decay_a"]) @ params["decay_b"]
    w = torch.exp(-torch.exp(dec.float())).to(x.dtype).reshape(B, S, nh, N)
    u = params["u"].reshape(nh, N)
    if impl == "kernel" and state is None:
        o = wkv6(r.float(), k.float(), v.float(), w.float(),
                 u.float()).to(x.dtype)
        sT = None     # the kernel path returns no state (the reference's)
    else:
        s0 = (torch.zeros((B, nh, N, N), dtype=x.dtype, device=x.device)
              if state is None else state["s"])
        o, sT = _wkv_scan(r, k, v, w, u, s0)
    o = _groupnorm(o, params["ln_scale"]).reshape(B, S, d) * g
    return o @ params["wo"], {"s": sT, "x_prev": x[:, -1]}


def rwkv_time_decode(params, x, cfg, state):
    """One-token step; x: (B,1,D)."""
    return rwkv_time_apply(params, x, cfg, state)


def rwkv_time_init_state(cfg, batch, dtype=torch.float32, device=None):
    d = cfg.d_model
    nh, N = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    kw = dict(dtype=dtype, device=device)
    return {"s": torch.zeros((batch, nh, N, N), **kw),
            "x_prev": torch.zeros((batch, d), **kw)}


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------

def rwkv_channel_init(gen, cfg, dtype=torch.float32, device=None):
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {"mu_k": torch.full((d,), 0.5, **kw),
            "mu_r": torch.full((d,), 0.5, **kw),
            "wk": dense_init(gen, (d, ff), **kw),
            "wv": dense_init(gen, (ff, d), **kw),
            "wr": dense_init(gen, (d, d), **kw)}


def rwkv_channel_specs(cfg):
    return {"mu_k": ("embed",), "mu_r": ("embed",), "wk": ("embed", "ff"),
            "wv": ("ff", "embed"), "wr": ("embed", "heads_embed")}


def rwkv_channel_apply(params, x, cfg, state=None):
    xx = _shift(x, state) - x
    xk = x + xx * params["mu_k"]
    xr = x + xx * params["mu_r"]
    k = torch.square(torch.relu(xk @ params["wk"]))
    y = torch.sigmoid(xr @ params["wr"]) * (k @ params["wv"])
    return y, {"x_prev": x[:, -1]}


def rwkv_channel_init_state(cfg, batch, dtype=torch.float32, device=None):
    return {"x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                  device=device)}
