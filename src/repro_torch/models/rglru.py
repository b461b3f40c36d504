"""RG-LRU recurrent block (Griffin / RecurrentGemma), the counterpart of
the reference's ``models/rglru.py``.

[arXiv:2402.19427]. Gated linear recurrence with input-dependent gates:
    r_t = σ(W_a y_t + b_a);  i_t = σ(W_x y_t + b_x)
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ y_t)
preceded by a width-4 causal temporal conv and wrapped in a GeGLU-style
output gate. The reference runs the recurrence with ``lax.scan``, outside
any Pallas kernel; here it is a loop over the sequence in the same order,
one fused multiply-add a step, in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def rglru_init(gen, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    dr = d                                # recurrent width = d_model
    kw = dict(dtype=dtype, device=device)
    # init decays spread in (0.9, 0.999), stored as softplus^-1(-log λ / c)
    lam = torch.linspace(0.9, 0.999, dr, dtype=torch.float32, device=device)
    lam = torch.log(torch.expm1(-torch.log(lam) / cfg.rglru_c))
    return {
        "w_in": dense_init(gen, (d, dr), **kw),
        "w_gate": dense_init(gen, (d, dr), **kw),
        "conv_w": dense_init(gen, (cfg.conv_width, dr),
                             scale=cfg.conv_width ** -0.5, **kw),
        "conv_b": torch.zeros((dr,), **kw),
        "w_a": dense_init(gen, (dr, dr), **kw),
        "b_a": torch.zeros((dr,), **kw),
        "w_x": dense_init(gen, (dr, dr), **kw),
        "b_x": torch.zeros((dr,), **kw),
        "lam": lam.to(dtype),
        "w_out": dense_init(gen, (dr, d), **kw),
    }


def rglru_specs(cfg):
    return {"w_in": ("embed", "rec"), "w_gate": ("embed", "rec"),
            "conv_w": ("conv", "rec"), "conv_b": ("rec",),
            "w_a": ("rec", "rec_in"), "b_a": ("rec",),
            "w_x": ("rec", "rec_in"), "b_x": ("rec",),
            "lam": ("rec",), "w_out": ("rec", "embed")}


def _conv(params, y, cfg, conv_state=None):
    """Causal depthwise temporal conv. y: (B,S,dr) → (out, the last W-1
    inputs, the next call's history). The taps sum in the reference's
    order."""
    W = cfg.conv_width
    hist = (y.new_zeros((y.shape[0], W - 1, y.shape[2]))
            if conv_state is None else conv_state)
    ypad = torch.cat([hist, y], dim=1)
    S = y.shape[1]
    out = 0
    for i in range(W):
        out = out + ypad[:, i:i + S] * params["conv_w"][i]
    return out + params["conv_b"], ypad[:, -(W - 1):]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_scan(params, y, cfg, h0):
    """Gates and log-decays in f32, then h = a_t·h + g_t step by step from
    ``h0``. Returns (h for every step (B,S,dr), the last h)."""
    c = cfg.rglru_c
    log_lam = -c * _softplus(params["lam"].float())
    r = torch.sigmoid((y @ params["w_a"] + params["b_a"]).float())
    i = torch.sigmoid((y @ params["w_x"] + params["b_x"]).float())
    log_a = log_lam * r                                   # (B,S,dr) f32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * y.float())
    # time-major, so each step reads and writes contiguous rows
    a, gated = a.transpose(0, 1).contiguous(), gated.transpose(0, 1)
    h = h0.float()
    if torch.is_grad_enabled() and (a.requires_grad or gated.requires_grad
                                    or h.requires_grad):
        # out= takes no autograd: a differentiable step list, stacked
        steps = []
        for t in range(a.shape[0]):
            h = torch.addcmul(gated[t], a[t], h)
            steps.append(h)
        hs = torch.stack(steps)
    else:
        hs = torch.empty_like(a)
        for t in range(a.shape[0]):
            h = torch.addcmul(gated[t], a[t], h, out=hs[t])
    # the state is a copy, so a cache does not hold all of ``hs`` alive
    return hs.transpose(0, 1).to(y.dtype), h.to(y.dtype, copy=True)


def rglru_apply(params, x, cfg, state=None):
    """Full-sequence recurrent block. x: (B,S,D) → (y, new_state); a state
    ``{"h", "conv"}`` carries a previous call's recurrence and conv
    history (prefill and decode), None starts from zeros."""
    B = x.shape[0]
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    y = x @ params["w_in"]
    conv_state = None if state is None else state["conv"]
    y, conv_state = _conv(params, y, cfg, conv_state)
    h0 = (x.new_zeros((B, y.shape[-1])) if state is None else state["h"])
    h, hT = _rglru_scan(params, y, cfg, h0)
    out = (h * gate) @ params["w_out"]
    return out, {"h": hT, "conv": conv_state}


def rglru_decode(params, x, cfg, state):
    return rglru_apply(params, x, cfg, state)


def rglru_init_state(cfg, batch, dtype=torch.float32, device=None):
    dr = cfg.d_model
    return {"h": torch.zeros((batch, dr), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype,
                                device=device)}

