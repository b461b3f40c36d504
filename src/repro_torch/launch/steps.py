"""Sharding helpers of the reference's ``launch/steps.py``: the optimizer
state's logical specs (``opt_spec_tree``), the decode caches' specs
(``_cache_pspec`` / ``cache_shardings_for``) and ``abstract_params``
(the params tree as ``torch.device("meta")`` tensors, the port's
``jax.eval_shape`` of ``model.init``).

Not ported: ``build_step`` and ``batch_abstract``, which lower and
compile a train, prefill or decode step with XLA for the reference's
dry-run on virtual 256- and 512-chip meshes (``launch/dryrun.py``);
PyTorch runs eagerly and has no such lowering.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.rules import NamedSharding, P
from repro_torch.tree import tree_map


def abstract_params(model, dtype=torch.float32):
    """``model``'s params tree with every leaf on the meta device: shapes
    and dtypes, no storage."""
    from repro_torch.models.model import Model
    meta = Model(model.cfg, device="meta", max_seq=model.max_seq)
    return meta.init(dtype=dtype, generator=torch.Generator())


def opt_spec_tree(opt_name: str, param_specs):
    """The optimizer state's logical specs, mirroring ``make_optimizer``'s
    state trees: AdamW's ``m``/``v`` are the params'; Adafactor factors a
    leaf of rank ≥ 2 into ``vr`` (its last name dropped) and ``vc`` (its
    second-last dropped)."""
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs, "t": ()}

    def leafspec(names):
        if len(names) >= 2:
            return {"vr": names[:-1], "vc": names[:-2] + names[-1:]}
        return {"v": names}
    return {"s": tree_map(leafspec, param_specs), "t": ()}


def _cache_pspec(path, leaf, mesh, dp, model_axis="model") -> P:
    """Sharding spec for one decode-cache leaf, by its key (the last
    entry of ``path``, a tuple of dict keys) and rank."""
    key = path[-1] if path else None
    nd = len(leaf.shape)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape.get(a, 1)
    msz = mesh.shape.get(model_axis, 1)
    dp_ax = dp if len(dp) > 1 else dp[0]

    def b_ax(b):
        return dp_ax if (b % dp_size == 0 and b >= dp_size) else None

    spec = [None] * nd
    if key in ("k", "v", "ck", "cv"):
        b, s = leaf.shape[nd - 4], leaf.shape[nd - 3]
        spec[nd - 4] = b_ax(b)
        if spec[nd - 4] is None and s % (dp_size * msz) == 0:
            spec[nd - 3] = tuple(dp) + (model_axis,)  # B=1 long-context
        elif s % msz == 0 and s >= msz:
            spec[nd - 3] = model_axis
    elif key in ("c_kv", "k_rope"):
        b, s = leaf.shape[nd - 3], leaf.shape[nd - 2]
        spec[nd - 3] = b_ax(b)
        if spec[nd - 3] is None and s % (dp_size * msz) == 0:
            spec[nd - 2] = tuple(dp) + (model_axis,)
        elif s % msz == 0 and s >= msz:
            spec[nd - 2] = model_axis
    elif key == "s":                        # rwkv state (..,B,nh,N,N)
        b, nh = leaf.shape[nd - 4], leaf.shape[nd - 3]
        spec[nd - 4] = b_ax(b)
        if nh % msz == 0:
            spec[nd - 3] = model_axis
    elif key in ("x_prev", "h"):            # (..,B,D)
        spec[nd - 2] = b_ax(leaf.shape[nd - 2])
        if leaf.shape[nd - 1] % msz == 0:
            spec[nd - 1] = model_axis
    elif key == "conv":                     # (..,B,W-1,dr)
        spec[nd - 3] = b_ax(leaf.shape[nd - 3])
        if leaf.shape[nd - 1] % msz == 0:
            spec[nd - 1] = model_axis
    return P(*spec)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return None if tree is None else fn(path, tree)


def cache_shardings_for(caches_abs, mesh, dp):
    """NamedShardings for a caches tree (``Model.init_caches``' layout;
    leaves with ``.shape``)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _cache_pspec(path, leaf, mesh, dp)), caches_abs)
