"""Adafactor (Shazeer & Stern 2018; the reference's
``optim/adafactor.py``): a factored second moment and no first moment,
so the state is ~(rows+cols)/(rows·cols) of Adam's.

The state mirrors the params tree. A leaf with ndim ≥ 2 is factored
over its last two axes, whatever leads them: a scan segment's (reps, …)
weights and the (reps, E, d, ff) expert weights keep ``vr`` (…, rows)
and ``vc`` (…, cols) per layer and expert, and the update's RMS clip is
taken over the whole stacked leaf, as the reference takes it. ``t`` is
a Python int: ``beta`` is computed from it in f32 on the host and
reaches the device as a scalar argument, so a step reads nothing back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params):
    def one(p):
        if _factored(p.shape):
            return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                    "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32)}
        return {"v": p.new_zeros(p.shape, dtype=torch.float32)}
    return {"s": tree_map(one, params), "t": 0}


@torch.no_grad()
def adafactor_update(params, grads, state, *, lr=1e-3, decay=0.8,
                     eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
                     grad_clip=None):
    """Returns (new_params, new_state); inputs are left untouched.
    ``grad_clip`` is accepted and unused, as in the reference (the
    update's RMS clip bounds the step)."""
    t = state["t"] + 1
    beta = float(np.float32(1.0) - (np.float32(t) + np.float32(1.0))
                 ** np.float32(-decay))
    lr = float(lr)

    def upd(p, g, s):
        g = g.float()
        g2 = torch.square(g) + eps
        if _factored(p.shape):
            vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            del g2
            denom = torch.mean(vr, dim=-1, keepdim=True)
            r = (vr / torch.clamp(denom, min=eps))[..., None]
            u = torch.rsqrt_(torch.clamp_(r * vc[..., None, :], min=eps))
            u.mul_(g)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
            new_s = {"v": v}
        rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u.div_(torch.clamp(rms_u / clip_threshold, min=1.0))
        if weight_decay:
            u.add_(weight_decay * p.float())
        return (p.float() - u.mul_(lr)).to(p.dtype), new_s

    outs = tree_map(upd, params, grads, state["s"])
    return _pick(outs, 0), {"s": _pick(outs, 1), "t": t}


def _pick(outs, i):
    if isinstance(outs, dict):
        return {k: _pick(v, i) for k, v in outs.items()}
    return outs[i]
