"""Step builders of the dry run (the reference's ``launch/steps.py``).

For every (arch, input shape, mesh) ``build_step`` makes:
    fn            — train_step | prefill | serve_step (one token)
    args          — ``torch.device("meta")`` tensors (no storage): the
                    reference's ``ShapeDtypeStruct`` stand-ins
    in_shardings  — a ``NamedSharding`` for every leaf of ``args``
    out_shardings — the same for the step's outputs
    out_abs       — a train or prefill step's outputs as meta tensors
so ``fn(*args)`` under ``cost_utils.StepCounter`` is the whole dry run
of a step (``launch/dryrun.py``), where the reference lowers and
compiles ``jax.jit(fn, in_shardings=...)``. Also here: the optimizer
state's logical specs (``opt_spec_tree``), the decode caches' specs
(``_cache_pspec`` / ``cache_shardings_for``) and ``abstract_params``
(the params tree as meta tensors, the port's ``jax.eval_shape`` of
``model.init``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models.model import Model
from repro_torch.optim import make_optimizer
from repro_torch.sharding.rules import (
    NamedSharding, P, batch_shardings, logical_to_shardings, make_rules)
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_map

PARAM_DTYPE = torch.bfloat16


def sub_quadratic_window(cfg, shape) -> Tuple[Optional[int], bool]:
    """(window, supported) for the given input shape. long_500k requires a
    sub-quadratic configuration: native for ssm/hybrid, sliding-window for
    the rest (DESIGN.md §4)."""
    if shape.name != "long_500k":
        return None, True
    if cfg.mixer == "rwkv6" or cfg.mixer == "rglru_hybrid":
        return None, True                   # natively sub-quadratic
    if cfg.decode_window:
        return cfg.decode_window, True
    return None, False


def abstract_params(model, dtype=torch.float32):
    """``model``'s params tree with every leaf on the meta device: shapes
    and dtypes, no storage."""
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


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_abstract(cfg, shape, kind: str):
    """The step's batch as meta tensors: int32 tokens (B, S), S = 1 for a
    decode step; an enc-dec model's frames (B, F, d_enc) in
    ``PARAM_DTYPE`` where the step runs its encoder."""
    B, S = shape.global_batch, shape.seq_len
    if kind == "decode":
        S = 1
    batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if cfg.encoder is not None and kind != "decode":
        e = cfg.encoder
        batch["frames"] = _meta((B, e.n_frames, e.d_model), PARAM_DTYPE)
    return batch


def build_step(arch: str, shape_name: str, mesh, *, rules_overrides=None,
               lr: float = 1e-4, cfg=None):
    """Returns dict(fn, args, in_shardings, out_shardings, cfg, model,
    meta) or None if the (arch, shape) pair is skipped (documented in
    DESIGN.md). ``mesh`` is a ``ModelMesh`` with devices
    (``make_production_mesh`` or ``make_host_mesh(..., device="meta")``):
    the model runs on its lead device, so a meta mesh gives a step on
    shapes alone, whose MoE layers take ``moe_apply_ep`` (static
    capacities, no host read)."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    dp = dp_axes_of(mesh)
    window, ok = sub_quadratic_window(cfg, shape)
    if not ok:
        return None
    kind = shape.kind
    max_seq = min(shape.seq_len, 32_768) if cfg.encoder is not None else 4096
    if window:
        max_seq = min(max_seq, window)
    model = Model(cfg, mesh=mesh, remat=(kind == "train"), max_seq=max_seq)
    rules = make_rules(cfg, mesh, overrides=rules_overrides)
    params_abs = abstract_params(model, dtype=PARAM_DTYPE)
    param_specs = model.specs()
    params_sh = logical_to_shardings(param_specs, rules, mesh, params_abs)
    meta = {"arch": arch, "shape": shape_name, "kind": kind,
            "window": window, "n_layers": cfg.n_layers}

    if kind == "train":
        opt_init, opt_update = make_optimizer(cfg.optimizer)
        opt_abs = opt_init(params_abs)
        opt_sh = logical_to_shardings(
            opt_spec_tree(cfg.optimizer, param_specs), rules, mesh, opt_abs)
        batch_abs = batch_abstract(cfg, shape, kind)
        batch_sh = batch_shardings(batch_abs, mesh, dp)

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(model.train_loss, params, batch)
            params, opt_state = opt_update(params, grads, opt_state, lr=lr,
                                           grad_clip=1.0)
            return params, opt_state, loss

        return dict(
            fn=train_step,
            args=(params_abs, opt_abs, batch_abs),
            in_shardings=(params_sh, opt_sh, batch_sh),
            out_shardings=(params_sh, opt_sh, NamedSharding(mesh, P())),
            out_abs=(params_abs, opt_abs, _meta((), torch.float32)),
            cfg=cfg, model=model, meta=meta)

    if kind == "prefill":
        batch_abs = batch_abstract(cfg, shape, kind)
        batch_sh = batch_shardings(batch_abs, mesh, dp)
        caches_abs = model.init_caches(shape.global_batch, shape.seq_len,
                                       dtype=PARAM_DTYPE, window=window)
        caches_sh = cache_shardings_for(caches_abs, mesh, dp)

        def prefill(params, batch):
            return model.prefill(params, batch, cache_len=shape.seq_len,
                                 window=window, dtype=PARAM_DTYPE)

        logits_abs = _meta((shape.global_batch, cfg.vocab), PARAM_DTYPE)
        return dict(
            fn=prefill,
            args=(params_abs, batch_abs),
            in_shardings=(params_sh, batch_sh),
            out_shardings=(batch_shardings(logits_abs, mesh, dp), caches_sh),
            out_abs=(logits_abs, caches_abs),
            cfg=cfg, model=model, meta=meta)

    # decode
    B = shape.global_batch
    cache_len = min(shape.seq_len, window) if window else shape.seq_len
    tokens_abs = _meta((B, 1), torch.int32)
    caches_abs = model.init_caches(B, cache_len, dtype=PARAM_DTYPE,
                                   window=window)
    caches_sh = cache_shardings_for(caches_abs, mesh, dp)
    pos_abs = _meta((), torch.int32)
    meta["cache_len"] = cache_len

    def serve_step(params, tokens, caches, pos):
        return model.decode_step(params, tokens, caches, pos, window=window)

    return dict(
        fn=serve_step,
        args=(params_abs, tokens_abs, caches_abs, pos_abs),
        in_shardings=(params_sh,
                      batch_shardings(tokens_abs, mesh, dp),
                      caches_sh, NamedSharding(mesh, P())),
        out_shardings=(batch_shardings(
            _meta((B, cfg.vocab), torch.float32), mesh, dp), caches_sh),
        cfg=cfg, model=model, meta=meta)
