"""Token-choice top-k MoE (the reference's ``models/moe.py``).

* ``moe_ref`` — the reference's single-device form: every expert runs
  densely on every token and the top-k outputs combine with the router's
  weights. E/k times the expert FLOPs of the routed form; the plain
  version the tests hold ``moe_apply`` to.
* ``moe_apply`` — the same function computed the routed way: each expert
  runs on the rows routed to it only (one device, no mesh).
* ``moe_apply_ep`` — the reference's expert-parallel form over a
  ``ModelMesh`` (``launch/mesh.py``): experts sharded over the ``data``
  axis, the expert ffn dim over ``model``. Tokens are capacity-bucketed
  (rows past a bucket's capacity drop, as the reference's do), exchanged
  between the mesh's shards (``_ALL_TO_ALL``, the reference's
  ``lax.all_to_all``), run through blocked per-expert products, summed
  over the ff shards and returned, in token chunks (the reference's
  ``lax.scan`` over ``dispatch_chunks``). One controller drives every
  shard in turn, as the reference's ``shard_map`` is one program: each
  shard's expert weights are ``w[e_lo:e_hi, :, f_lo:f_hi]`` of the whole
  leaf moved to its device: a view on one card, so autograd reaches the
  leaf. ``make_host_mesh`` puts every slot on one device; a mesh built
  by hand over distinct cards runs too, but copies each shard's blocks
  to its card on every call (the experts are not held resident there
  yet). Every buffer size follows from static
  shapes, so the EP form reads nothing back from the device.
  ``moe_apply(..., mesh=...)`` dispatches to it.

Router aux loss is the standard load-balance term E·Σ_e f_e·P_e.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
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


def moe_specs(cfg):
    return {"w_router": ("embed", "router"),
            "w_gate": ("experts", "embed", "ff"),
            "w_up": ("experts", "embed", "ff"),
            "w_down": ("experts", "ff", "embed")}


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


# ---------------------------------------------------------------------------
# expert-parallel form over a mesh
# ---------------------------------------------------------------------------

def all_to_all(bufs, devices):
    """The exchange of one expert-parallel group (the reference's tiled
    ``lax.all_to_all`` over axis 0): ``bufs[i]`` is shard i's (ep, ...)
    send buffer, and shard j receives row block j of every shard's
    buffer, stacked in source order on ``devices[j]``."""
    return [torch.stack([b[j].to(dev) for b in bufs])
            for j, dev in enumerate(devices)]


# module-level indirection so the exchanges are observable: tests
# monkeypatch ``moe._ALL_TO_ALL`` and count 4 a dispatch chunk
_ALL_TO_ALL = all_to_all


def _bucketize(keys, n_buckets, cap):
    """Stable-sort rows by bucket key; per-bucket slot positions with a
    capacity limit. Returns (order, key_sorted, pos_clipped, keep_sorted):
    rows beyond ``cap`` in their bucket get pos == cap (overflow slot)."""
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    start = torch.searchsorted(ks, ks, side="left")
    pos = torch.arange(keys.shape[0], device=keys.device) - start
    keep = pos < cap
    return order, ks, torch.where(keep, pos, cap), keep


class _Layout:
    """Where ``moe_apply_ep``'s shards live on ``mesh``. Token shard ``s``
    (row-major over ``dp_axes``, the reference's ``P(dp_axes)`` split of
    the token dim) holds expert block ``ep_of[s]`` (its coordinate on
    ``ep_axis``) and exchanges within its group (the shards that differ
    only on ``ep_axis``); ``dev[s][j]`` is its device at ff shard ``j``
    of ``tp_axis``, ``dev[s][0]`` where its routing runs."""

    def __init__(self, mesh, cfg, dp_axes, ep_axis, tp_axis):
        extra = set(mesh.axis_names) - set(dp_axes) - {tp_axis}
        if extra or ep_axis not in dp_axes:
            raise ValueError(
                f"moe_apply_ep runs on a mesh of the token axes {dp_axes} "
                f"(holding the expert axis {ep_axis!r}) and the ff axis "
                f"{tp_axis!r}; got {mesh.axis_names}")
        m = cfg.moe
        self.ep = mesh.shape.get(ep_axis, 1)
        self.tp = mesh.shape.get(tp_axis, 1)
        if m.n_experts % self.ep or m.d_ff % self.tp:
            raise ValueError(
                f"{m.n_experts} experts of d_ff {m.d_ff} do not split over "
                f"{ep_axis}={self.ep}, {tp_axis}={self.tp}")
        self.E_loc, self.F_loc = m.n_experts // self.ep, m.d_ff // self.tp
        sizes = [mesh.shape.get(a, 1) for a in dp_axes]
        self.dp = int(np.prod(sizes))
        self.lead = mesh.lead
        self.ep_of, self.dev, groups = [], [], {}
        for s in range(self.dp):
            coords = dict(zip(dp_axes, (int(c) for c in
                                        np.unravel_index(s, sizes))))
            self.ep_of.append(coords[ep_axis])
            groups.setdefault(tuple(c for a, c in coords.items()
                                    if a != ep_axis), []).append(s)
            at = {a: c for a, c in coords.items() if a in mesh.shape}
            self.dev.append([mesh.device(**at, **({tp_axis: j}
                                                  if tp_axis in mesh.shape
                                                  else {}))
                             for j in range(self.tp)])
        self.groups = list(groups.values())

    def experts(self, params):
        """Each token shard's (w_gate, w_up, w_down) blocks, one triple an
        ff shard, each on its device: ``w[e_lo:e_hi, :, f_lo:f_hi]`` of
        the whole leaf, as views from one ``split`` a dim (whose backward
        assembles the leaf's grad once, where a slice a block would
        scatter each into a zero copy of the leaf)."""
        blocks = {}
        for name, ff_dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
            blocks[name] = [e.split(self.F_loc, dim=ff_dim) for e in
                            params[name].split(self.E_loc, dim=0)]
        return [[tuple(blocks[n][self.ep_of[s]][j].to(self.dev[s][j])
                       for n in ("w_gate", "w_up", "w_down"))
                 for j in range(self.tp)] for s in range(self.dp)]


def _exchange(lay, bufs):
    """One exchange over every group: ``bufs[s]`` is token shard s's
    send buffer; returns each shard's received buffer."""
    out = [None] * lay.dp
    for group in lay.groups:
        got = _ALL_TO_ALL([bufs[s] for s in group],
                          [lay.dev[s][0] for s in group])
        for s, g in zip(group, got):
            out[s] = g
    return out


def _ff_sum(lay, s, experts, x, eq):
    """The expert products of shard ``s`` on ``x`` summed over its ff
    shards in shard order (the reference's ``psum`` over ``model``),
    on ``dev[s][0]``. ``eq`` is the products' einsum."""
    y = None
    for (w_gate, w_up, w_down), dev in zip(experts, lay.dev[s]):
        xj = x.to(dev)
        h = F.silu(torch.einsum(eq[0], xj, w_gate)) \
            * torch.einsum(eq[0], xj, w_up)
        part = torch.einsum(eq[1], h, w_down).to(lay.dev[s][0])
        y = part if y is None else y + part
    return y


def _moe_chunk(xs, wr, experts, cfg, lay):
    """One token chunk on every token shard: ``xs[s]`` (t, D) on
    ``dev[s][0]``. Returns (ys, auxs), one a shard."""
    m = cfg.moe
    k, ep, E_loc = m.top_k, lay.ep, lay.E_loc
    t, D = xs[0].shape
    R = t * k
    C = max(1, math.ceil(R / ep * m.capacity_factor))
    disp, send_x, send_le, send_ok = [], [], [], []
    for s, x_c in enumerate(xs):
        _, weights, ids, aux = _router(x_c, wr[s], k)
        eid = ids.reshape(R)
        dst = torch.div(eid, E_loc, rounding_mode="floor")  # owning shard
        order, dst_s, pos_cl, keep = _bucketize(dst, ep, C)
        at = (dst_s, pos_cl)
        dev = x_c.device
        send_x.append(x_c.new_zeros((ep, C + 1, D)).index_put(
            at, x_c[torch.div(order, k, rounding_mode="floor")])[:, :C])
        send_le.append(torch.zeros((ep, C + 1), dtype=eid.dtype, device=dev)
                       .index_put(at, (eid % E_loc)[order])[:, :C])
        send_ok.append(torch.zeros((ep, C + 1), dtype=torch.bool, device=dev)
                       .index_put(at, keep)[:, :C])
        disp.append((order, dst_s, pos_cl, keep, weights, aux))
    recv_x = _exchange(lay, send_x)
    recv_le = _exchange(lay, send_le)
    recv_ok = _exchange(lay, send_ok)

    # local per-expert capacity buckets
    R2 = ep * C
    Ce = max(1, math.ceil(R2 / E_loc * m.capacity_factor))
    recv_y = []
    for s in range(lay.dp):
        rows2 = recv_x[s].reshape(R2, D)
        le = torch.where(recv_ok[s].reshape(R2), recv_le[s].reshape(R2),
                         E_loc)
        order2, le_s, pos2_cl, keep2 = _bucketize(le, E_loc + 1, Ce)
        xe = rows2.new_zeros((E_loc + 1, Ce + 1, D)).index_put(
            (le_s, pos2_cl), rows2[order2])[:E_loc, :Ce]
        ye = _ff_sum(lay, s, experts[s], xe, ("ecd,edf->ecf",
                                              "ecf,efd->ecd"))
        # invert the local bucketing
        yb = F.pad(ye, (0, 0, 0, 1, 0, 1))
        y_sorted = yb[le_s, pos2_cl] * keep2[:, None].to(ye.dtype)
        recv_y.append(torch.zeros_like(rows2).index_put((order2,), y_sorted)
                      .reshape(ep, C, D))
    send_y = _exchange(lay, recv_y)

    # invert the dispatch bucketing
    ys, auxs = [], []
    for s, (order, dst_s, pos_cl, keep, weights, aux) in enumerate(disp):
        sy = F.pad(send_y[s], (0, 0, 0, 1))
        y_src = sy[dst_s, pos_cl] * keep[:, None].to(sy.dtype)
        y_flat = y_src.new_zeros((R, D)).index_put((order,), y_src)
        ys.append(torch.sum(y_flat.reshape(t, k, D) * weights[..., None],
                            dim=1))
        auxs.append(aux)
    return ys, auxs


def _moe_body(params, xf, cfg, lay):
    """The chunked body: the token dim split over the token shards, each
    shard's tokens in ``dispatch_chunks`` chunks (the largest count up to
    it that divides them), the chunks in order. Returns (y on the lead
    device, aux: each shard's mean over its chunks, averaged over the
    shards, the reference's ``pmean``)."""
    T_loc = xf.shape[0] // lay.dp
    n_chunks = 1
    for c in range(min(cfg.moe.dispatch_chunks, T_loc), 0, -1):
        if T_loc % c == 0:
            n_chunks = c
            break
    t = T_loc // n_chunks
    xs = [xf[s * T_loc:(s + 1) * T_loc].to(lay.dev[s][0])
          for s in range(lay.dp)]
    wr = [params["w_router"].to(lay.dev[s][0]) for s in range(lay.dp)]
    experts = lay.experts(params)
    ys = [[] for _ in range(lay.dp)]
    auxs = [[] for _ in range(lay.dp)]
    for c in range(n_chunks):
        y_c, aux_c = _moe_chunk([x[c * t:(c + 1) * t] for x in xs], wr,
                                experts, cfg, lay)
        for s in range(lay.dp):
            ys[s].append(y_c[s])
            auxs[s].append(aux_c[s])
    y = torch.cat([torch.cat(y_s).to(lay.lead) for y_s in ys])
    aux = torch.mean(torch.stack([torch.mean(torch.stack(a)).to(lay.lead)
                                  for a in auxs]))
    return y, aux


def _moe_small_body(params, xf, cfg, lay):
    """The decode-time body: too few tokens to split, so every shard of
    one group sees them all, runs only its LOCAL experts densely and the
    outputs sum over (expert shard, ff shard) in order, the reference's
    one ``psum``. Exact: no capacity drops. The router's values are the
    same on every shard, so it runs once, on the lead device."""
    E_loc = lay.E_loc
    _, weights, ids, aux = _router(xf, params["w_router"], cfg.moe.top_k)
    slots = torch.arange(E_loc, device=ids.device)
    experts = lay.experts(params)
    y = None
    for s in lay.groups[0]:
        lo = lay.ep_of[s] * E_loc
        local = (ids >= lo) & (ids < lo + E_loc)
        w_loc = torch.where(local, weights, torch.zeros_like(weights))
        onehot = ((ids - lo)[..., None] == slots).to(xf.dtype)
        w_te = torch.sum(onehot * w_loc[..., None], dim=1)     # (T, E_loc)
        y_e = _ff_sum(lay, s, experts[s], xf, ("td,edf->tef",
                                               "tef,efd->ted"))
        part = torch.einsum("ted,te->td", y_e, w_te.to(y_e.device))
        y = part.to(lay.lead) if y is None else y + part.to(lay.lead)
    return y, aux


def moe_apply_ep(params, x, cfg, mesh, dp_axes=("data",), ep_axis="data",
                 tp_axis="model"):
    """x: (..., D) on the mesh's lead device, its tokens split over
    ``dp_axes``. Returns (y, aux) on the lead device. Too few tokens to
    split (``T % dp != 0`` or ``T < 4 dp``, the reference's test) take
    the small body, the rest the chunked one."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    T = xf.shape[0]
    lay = _Layout(mesh, cfg, tuple(dp_axes), ep_axis, tp_axis)
    if T % lay.dp != 0 or T < 4 * lay.dp:
        y, aux = _moe_small_body(params, xf, cfg, lay)
    else:
        y, aux = _moe_body(params, xf, cfg, lay)
    return y.reshape(shape), aux


def moe_apply(params, x, cfg, mesh=None, dp_axes=("data",)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ref``'s function, routed: the T·k (token, expert) rows are
    stable-sorted by expert, each expert's three products run on its
    tokens only, each output row goes back to its (token, slot) place of
    a (T, k, D) buffer (every place written once: no atomics, the same
    sums on every run) and the slots sum with the router's weights, as
    ``moe_ref`` sums them. x: (..., D). Returns (y, aux_loss).

    The slice sizes are read on the host: one device→host copy of the
    E + 1 expert offsets per call (one host sync per MoE layer). With a
    ``mesh`` it runs ``moe_apply_ep`` instead (no host sync; capacity
    drops)."""
    if mesh is not None:
        return moe_apply_ep(params, x, cfg, mesh, dp_axes=dp_axes)
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
