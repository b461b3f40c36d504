"""AdamW over a tree of tensors (the reference's ``optim/adamw.py``):
nested dicts, the state's ``m``/``v`` mirroring the params tree. ``t``
is a Python int, so a step reads nothing back from the device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map


def adamw_init(params):
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros), "t": 0}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, grad_clip=None):
    """Returns (new_params, new_state); inputs are left untouched."""
    t = state["t"] + 1
    if grad_clip is not None:
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2)
                            for g in leaves(grads)) + 1e-12)
        scale = torch.clamp(grad_clip / gn, max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                 state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float() ** 2,
                 state["v"], grads)
    # the bias corrections in f32, as the reference computes them
    bc1 = float(1 - np.float32(b1) ** np.float32(t))
    bc2 = float(1 - np.float32(b2) ** np.float32(t))
    lr = float(lr)

    def upd(p, m_, v_):
        step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)
    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
