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
changes no value. ``logical_to_shardings``' ``abs_tree`` takes anything
with a ``.shape``: tensors on ``torch.device("meta")`` are the port's
``jax.eval_shape``.
"""
from __future__ import annotations

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
