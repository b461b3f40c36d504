"""AdamW over a dict of tensors (the reference's ``optim/adamw.py``)."""
from __future__ import annotations

import torch


def adamw_init(params):
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "t": 0}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, grad_clip=None):
    """Returns (new_params, new_state); inputs are left untouched."""
    t = state["t"] + 1
    if grad_clip is not None:
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2)
                            for g in grads.values()) + 1e-12)
        scale = torch.clamp(grad_clip / gn, max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
    m = {k: b1 * state["m"][k] + (1 - b1) * grads[k].float() for k in params}
    v = {k: b2 * state["v"][k] + (1 - b2) * grads[k].float() ** 2
         for k in params}
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    new_params = {}
    for k, p in params.items():
        step = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        new_params[k] = (p.float() - lr * step).to(p.dtype)
    return new_params, {"m": m, "v": v, "t": t}
