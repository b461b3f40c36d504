"""Token-choice top-k MoE (the reference's ``models/moe.py``, one device).

* ``moe_ref`` — the reference's single-device form: every expert runs
  densely on every token and the top-k outputs combine with the router's
  weights. E/k times the expert FLOPs of the routed form; the plain
  version the tests hold ``moe_apply`` to.
* ``moe_apply`` — the same function computed the routed way: each expert
  runs on the rows routed to it only.

Router aux loss is the standard load-balance term E·Σ_e f_e·P_e. The
expert-parallel form (the reference's ``moe_apply_ep``: capacity
buckets, ``all_to_all`` over a mesh) waits for the expert-parallel
slice of the port.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def moe_init(gen, cfg, dtype=torch.float32, device=None):
    d, m = cfg.d_model, cfg.moe
    kw = dict(dtype=dtype, device=device)
    return {
        "w_router": dense_init(gen, (d, m.n_experts), **kw),
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_ff), scale=d ** -0.5,
                             **kw),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_ff), scale=d ** -0.5,
                           **kw),
        "w_down": dense_init(gen, (m.n_experts, m.d_ff, d),
                             scale=m.d_ff ** -0.5, **kw),
    }


def _router(x, w_router, top_k):
    """x: (T,D) → probs (T,E), weights (T,k), ids (T,k), aux scalar."""
    logits = (x @ w_router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.sum(weights, -1, keepdim=True)
    E = probs.shape[-1]
    assign = torch.zeros_like(probs).scatter_(1, ids, 1.0)
    f = torch.mean(assign, 0) / top_k
    p = torch.mean(probs, 0)
    aux = E * torch.sum(f * p)
    return probs, weights.to(x.dtype), ids, aux


def _expert(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe_ref(params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D). Returns (y, aux_loss)."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    _, weights, ids, aux = _router(xf, params["w_router"], cfg.moe.top_k)
    h = F.silu(torch.einsum("td,edf->tef", xf, params["w_gate"])) \
        * torch.einsum("td,edf->tef", xf, params["w_up"])
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"])     # (T,E,D)
    sel = torch.gather(y_all, 1, ids[..., None].expand(-1, -1, shape[-1]))
    y = torch.sum(sel * weights[..., None], dim=1)
    return y.reshape(shape), aux


def moe_apply(params, x, cfg, mesh=None) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``moe_ref``'s function, routed: the T·k (token, expert) rows are
    stable-sorted by expert, each expert's three products run on its
    tokens only, each output row goes back to its (token, slot) place of
    a (T, k, D) buffer (every place written once: no atomics, the same
    sums on every run) and the slots sum with the router's weights, as
    ``moe_ref`` sums them. x: (..., D). Returns (y, aux_loss).

    The slice sizes are read on the host: one device→host copy of the
    E + 1 expert offsets per call (one host sync per MoE layer).
    ``mesh`` (the expert-parallel form) raises."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply over a mesh (the expert-parallel moe_apply_ep) waits "
            "for the expert-parallel slice of the port")
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    T, k = xf.shape[0], cfg.moe.top_k
    E = params["w_router"].shape[-1]
    _, weights, ids, aux = _router(xf, params["w_router"], k)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    bounds = torch.searchsorted(
        flat[order], torch.arange(E + 1, device=x.device, dtype=flat.dtype))
    bounds = bounds.cpu().tolist()                 # the one host read
    tok = torch.div(order, k, rounding_mode="floor")
    y_sorted = torch.empty((T * k, shape[-1]), dtype=x.dtype,
                           device=x.device)
    # one unbind a weight: its backward stacks the experts' grads once
    experts = zip(*(params[n].unbind(0)
                    for n in ("w_gate", "w_up", "w_down")))
    for e, (w_gate, w_up, w_down) in enumerate(experts):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            y_sorted[lo:hi] = _expert(xf.index_select(0, tok[lo:hi]),
                                      w_gate, w_up, w_down)
    y_tk = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    y = torch.sum(y_tk.reshape(T, k, -1) * weights[..., None], dim=1)
    return y.reshape(shape), aux
