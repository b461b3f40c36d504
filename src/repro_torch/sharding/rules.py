"""Logical-axis → mesh-axis sharding rules (the reference's
``sharding/rules.py``).

Params carry logical names (each model module's ``*_specs``); a rules
dict maps them to mesh axes. The defaults are the reference's: TP over
``model`` (ff, heads, vocab), expert-parallel over ``data``, FSDP over
``data`` for models of at least ``FSDP_THRESHOLD`` params, and pure DP
over ``pod``. The math is the reference's to the tuple, so a spec made
here equals the reference's spec for the same names, rules and shapes.

``P`` is a tuple of mesh-axis names, ``None``s and tuples of names (the
reference's ``PartitionSpec``). ``NamedSharding`` pairs a spec with its
``ModelMesh``. A sharding is placement, not value: the port's mesh runs
every layer but the MoE's experts on the mesh's lead device
(``models/moe.py`` places those), as the reference's GSPMD placement
changes no value. The dry run's count of one device's program of a
grid places by them for real: ``placements`` and ``place`` turn specs
into DTensor placements on a fake grid (``launch/spmd.py``), and the
model's sharding sites (``constrain``, ``local_over``) act there alone.
``logical_to_shardings``' ``abs_tree`` takes anything with a
``.shape``: tensors on ``torch.device("meta")`` are the port's
``jax.eval_shape``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.tree import tree_map

FSDP_THRESHOLD = 8e9


class P(tuple):
    """A PartitionSpec: one entry a dim, each a mesh-axis name, a tuple
    of names, or ``None`` (replicated). Entries normalize as the
    reference's do: a list becomes a tuple, an empty one ``None``, a
    one-name one that name."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_entry(a) for a in axes))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _entry(ax):
    if isinstance(ax, (list, tuple)):
        ax = tuple(ax)
        if len(ax) <= 1:
            return ax[0] if ax else None
    return ax


@dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: P


def make_rules(cfg, mesh, *, fsdp: Optional[bool] = None,
               overrides: Optional[Dict] = None) -> Dict[str, object]:
    model_size = mesh.shape.get("model", 1)
    if fsdp is None:
        fsdp = cfg.param_count() >= FSDP_THRESHOLD
    rules: Dict[str, object] = {
        "layers": None,
        "vocab": "model",
        "embed": "data" if fsdp else None,
        "heads": "model",
        "kv_heads": ("model" if cfg.n_kv_heads % model_size == 0 else None),
        "head_dim": None,
        "q_lora": None,
        "kv_lora": None,
        "ff": "model",
        "experts": "data",
        "router": None,
        "lora": None,
        "proj5": None,
        "heads_embed": "model",      # rwkv square projections
        "rec": "model",
        "rec_in": None,
        "conv": None,
        "frames": None,
        "seq": None,
    }
    if cfg.n_heads % model_size != 0:
        # uneven head sharding pads in GSPMD; for small head counts the
        # waste exceeds the win, so heads fall back to replicated (the ff
        # dim still gives the model axis plenty to do)
        if cfg.n_heads < 2 * model_size:
            rules["heads"] = None
    if overrides:
        rules.update(overrides)
    return rules


def _axis_size(mesh, ax) -> int:
    if isinstance(ax, (list, tuple)):
        n = 1
        for a in ax:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(ax, 1)


def _spec_for(names: Tuple, rules: Dict[str, object], mesh,
              shape: Tuple[int, ...] = None) -> P:
    used = set()
    axes = []
    for i, nm in enumerate(names):
        ax = rules.get(nm) if nm is not None else None
        # an input sharding requires exact divisibility (no padding for
        # arguments): drop the axis when the dim does not divide
        if ax is not None and shape is not None:
            if shape[i] % _axis_size(mesh, ax) != 0:
                ax = None
        # a mesh axis may appear at most once per spec
        key = tuple(ax) if isinstance(ax, (list, tuple)) else (ax,)
        if ax is not None and not any(k in used for k in key):
            axes.append(ax)
            used.update(key)
        else:
            axes.append(None)
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)


def logical_to_shardings(specs_tree, rules: Dict[str, object], mesh,
                         abs_tree=None):
    """Map a tree of logical-name tuples to NamedShardings. With
    ``abs_tree`` (leaves with ``.shape``, e.g. meta tensors; a Python
    scalar, such as an optimizer's step count, has shape ``()``) the
    specs are legalized against the actual dims."""
    if abs_tree is None:
        return tree_map(
            lambda names: NamedSharding(mesh, _spec_for(names, rules, mesh)),
            specs_tree)
    return tree_map(
        lambda names, ab: NamedSharding(
            mesh, _spec_for(names, rules, mesh,
                            tuple(getattr(ab, "shape", ())))),
        specs_tree, abs_tree)


def _dp(mesh, dp_axes):
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    dp_size = 1
    for a in dp_axes:
        dp_size *= mesh.shape.get(a, 1)
    return dp, dp_size


def batch_shardings(batch_tree, mesh, dp_axes=("data",)):
    """Shard every batch leaf's leading dim over dp (replicate if it does
    not divide)."""
    dp, dp_size = _dp(mesh, dp_axes)

    def one(x):
        ndim = len(getattr(x, "shape", ()))
        b = x.shape[0] if ndim > 0 else 0
        if b and b % dp_size == 0:
            return NamedSharding(mesh, P(dp, *([None] * (ndim - 1))))
        return NamedSharding(mesh, P())
    return tree_map(one, batch_tree)


# --- memo-store rules ----------------------------------------------------
# The sharded memo tier partitions ROWS (positions) of every device-
# resident leaf over one mesh axis; routing state and the hot set
# replicate (``core/shard.py``'s ``row_split`` places them). Logical
# rules, so they legalize through ``_spec_for`` as model params do.

def memo_store_rules(axis: str = "store") -> Dict[str, object]:
    """Logical-name → mesh-axis rules for the sharded memo store."""
    return {
        "memo_rows": axis,        # table/arena row (position) dim
        "memo_part": None,        # trailing per-entry dims
        "memo_repl": None,        # centroids / owners / hot set
    }


def memo_row_spec(mesh, ndim: int, *, axis: str = "store",
                  shape: Optional[Tuple[int, ...]] = None) -> P:
    """PartitionSpec for one row-sharded memo leaf of rank ``ndim``: dim 0
    over ``axis`` (legalized against ``shape`` when given), trailing dims
    replicated."""
    names = ("memo_rows",) + ("memo_part",) * (ndim - 1)
    return _spec_for(names, memo_store_rules(axis), mesh, shape)


def memo_store_shardings(mesh, abs_tree, *, axis: str = "store"):
    """Row-sharded NamedShardings for a tree of memo-store leaves: the
    leading dim partitions over ``axis``, everything else replicates; a
    row count that does not divide the axis legalizes to replicated."""
    def one(ab):
        shape = tuple(ab.shape)
        ndim = max(1, len(shape))
        return NamedSharding(mesh, memo_row_spec(mesh, ndim, axis=axis,
                                                 shape=shape))
    return tree_map(one, abs_tree)


def cache_shardings(cache_tree, mesh, dp_axes=("data",), seq_axis="model"):
    """Decode-cache shardings: batch over dp when divisible, the long axis
    (cache sequence / rwkv heads) over ``model``; for B == 1 long-context
    the sequence spreads over (data, model)."""
    dp, dp_size = _dp(mesh, dp_axes)
    model_size = mesh.shape.get(seq_axis, 1)

    def one(x):
        ndim = len(x.shape)
        if ndim < 2:
            return NamedSharding(mesh, P())
        B, S = x.shape[0], x.shape[1]
        b_ax = dp if (B % dp_size == 0 and B >= dp_size) else None
        if b_ax is None:
            # B=1 long-context: shard the big axis over everything
            total = tuple(dp_axes) + (seq_axis,)
            if S % (dp_size * model_size) == 0:
                return NamedSharding(
                    mesh, P(None, total, *([None] * (ndim - 2))))
            if S % model_size == 0:
                return NamedSharding(
                    mesh, P(None, seq_axis, *([None] * (ndim - 2))))
            return NamedSharding(mesh, P())
        s_ax = seq_axis if S % model_size == 0 and S >= model_size else None
        return NamedSharding(mesh, P(b_ax, s_ax, *([None] * (ndim - 2))))
    return tree_map(one, cache_tree)


# --- one device's program on a fake grid (``launch/spmd.py``) -------------
# A ``NamedSharding`` becomes DTensor placements on the grid's
# ``DeviceMesh``; ``place`` puts a tree of tensors there, one device's
# shard a leaf. The model's sharding sites (``constrain``,
# ``local_over``) act only on DTensors, so one controller runs them as
# the no-ops they are there.

def placements(sharding, device_mesh):
    """DTensor placements of ``sharding`` on ``device_mesh``: ``Shard(d)``
    on each mesh axis the spec names at dim ``d`` (each axis of a tuple
    entry such as ``("pod", "data")``), ``Replicate()`` on the rest and
    on an axis of size 1, where a shard is the whole."""
    from torch.distributed.tensor import Replicate, Shard
    names = device_mesh.mesh_dim_names
    out = [Replicate()] * device_mesh.ndim
    for d, ax in enumerate(sharding.spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a in names and device_mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(d)
    return out


def place(tree, shardings, device_mesh):
    """``tree`` (nested dicts, tuples and lists of tensors; other leaves
    kept) as DTensors on ``device_mesh`` under the matching
    ``shardings``. A leaf's local tensor is device 0's shard of it, a
    copy (a replicated leaf keeps the tensor itself), so its bytes are
    ``cost_utils.shard_bytes``."""
    import torch
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(sh, device_mesh)
        local = t
        for i, p in enumerate(pl):
            if p.is_shard():
                n = local.shape[p.dim]
                local = local.narrow(p.dim, 0,
                                     -(-n // device_mesh.size(i)))
        if local is not t:
            local = local.clone()
        return DTensor.from_local(local, device_mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return _zip_map(one, tree, shardings)


def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over ``tree``; a ``NamedSharding`` where
    ``shardings`` stops short covers the whole subtree."""
    if tree is None:
        return None
    one = isinstance(shardings, NamedSharding)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings if one else shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, shardings if one else s)
                          for v, s in zip(tree, [None] * len(tree)
                                          if one else shardings))
    return fn(tree, shardings)


def redistribute(tree, shardings):
    """Every DTensor leaf of ``tree`` moved to the matching sharding's
    placements (the reference's ``out_shardings``: XLA reshards a
    step's outputs to them); other leaves kept."""
    def one(t, sh):
        if not is_sharded(t):
            return t
        return t.redistribute(t.device_mesh, placements(sh, t.device_mesh))
    return _zip_map(one, tree, shardings)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint(x, spec)``: a DTensor
    ``x`` moved to ``spec``'s placements; anything else as it is, since
    one controller places nothing."""
    if not is_sharded(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(NamedSharding(None, spec), mesh))


def local_over(fn, args, roles, out_roles, free, partial=None):
    """``fn(*args)``, on each device's shard where ``args[0]`` is a
    DTensor (under DTensor's ``local_map``): ``fn`` works element by
    element along the dims whose role is in ``free`` (batch, heads,
    channels) and across the others (time, a contracted dim). ``roles``
    names each argument's dims, one letter a dim (``"tbc"``), and
    ``out_roles`` the output's (a tuple of them for several outputs).

    Each mesh axis shards one role where every argument holding it
    splits evenly: the role the largest argument already shards there
    (moving the largest costs most), else the first role of ``free``
    (so ``"hb"`` prefers heads to batch), else none (replicated). Each
    argument moves there first, its exchange counted as DTensor issues
    it, as GSPMD moves an operand to the split it chooses.

    ``partial`` maps a role ``fn`` reduces over to the reduction
    (``{"s": "sum"}``): a mesh axis may shard it too, and an output
    without it is ``Partial`` over that axis, resolved by the exchange
    DTensor makes when it is next read whole. A recurrence run this way
    is one local op a step, where DTensor would dispatch each step's
    ops."""
    if not is_sharded(args[0]):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    partial = partial or {}
    mesh = args[0].device_mesh
    axis_role = [None] * mesh.ndim

    def fits(r, i):
        n = mesh.size(i) * math.prod(mesh.size(j) for j, rj in
                                     enumerate(axis_role) if rj == r)
        return all(a.shape[rs.index(r)] % n == 0
                   for a, rs in zip(args, roles) if r in rs)
    by_size = sorted(zip(args, roles), key=lambda ar: -ar[0].numel())
    for a, rs in by_size:
        for i, p in enumerate(getattr(a, "placements", ())):
            r = rs[p.dim] if p.is_shard() else None
            if (r is not None and axis_role[i] is None
                    and (r in free or r in partial) and fits(r, i)):
                axis_role[i] = r
    for i in range(mesh.ndim):
        if axis_role[i] is None and mesh.size(i) > 1:
            axis_role[i] = next((r for r in free if fits(r, i)), None)

    def pl(rs, out=False):
        return [Shard(rs.index(r)) if r is not None and r in rs
                else Partial(partial[r]) if out and r in partial
                else Replicate() for r in axis_role]
    args = tuple(a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args)
    outs = (pl(out_roles, True) if isinstance(out_roles, str)
            else tuple(pl(r, True) for r in out_roles))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(pl(r) for r in roles),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def is_sharded(x, dim=None) -> bool:
    """Whether ``x`` is a DTensor (one device's program on a fake grid:
    none exists while no process group is up); with ``dim``, one whose
    dim ``dim`` is split over the grid."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return False
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return False
    return dim is None or any(p.is_shard(dim) and x.device_mesh.size(i) > 1
                              for i, p in enumerate(x.placements))
