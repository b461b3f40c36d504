"""Carry JAX-side state into the port: numpy arrays in, tensors on a
given device out. The reference's parameter trees use the same keys and
layouts as the port's, so the bridge is a name map; the reference
objects are read through their attributes (duck typing), so nothing
here imports JAX or the reference package.

Random init and embedder training cannot match across frameworks, so a
parity test builds one reference engine and serves its exact state in
both packages through ``engine_from_reference``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.embedding import Embedder
from repro_torch.core.engine import MemoEngine
from repro_torch.memo.specs import MemoSpec


def tree_to_torch(tree, device):
    """A nested dict of arrays (a JAX params pytree) → the same nesting
    of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def embedder_from_reference(embedder, device) -> Embedder:
    """A reference ``Embedder`` (params, pool, act) → the port's."""
    return Embedder(tree_to_torch(dict(embedder.params), device),
                    int(embedder.pool), str(embedder.act))


def spec_from_reference(spec) -> MemoSpec:
    """A reference ``MemoSpec`` → the port's (fields the port has no use
    for are dropped)."""
    return MemoSpec.from_dict(spec.to_dict())


def engine_from_reference(ref_engine, model, *, device,
                          spec: MemoSpec = None) -> MemoEngine:
    """A built reference ``MemoEngine`` → a port engine serving the same
    weights, embedder, store state and ``sim_cal`` on ``device`` (the
    store's device tier is re-materialized by a full sync)."""
    eng = MemoEngine(model, tree_to_torch(ref_engine.params, device),
                     spec if spec is not None
                     else spec_from_reference(ref_engine.mc))
    eng.embedder = embedder_from_reference(ref_engine.embedder, device)
    state = ref_engine.store.state_dict()
    eng.store = eng._make_store(tuple(ref_engine.store.apm_shape),
                                capacity=max(1, int(state["n"])))
    eng.store.load_state_dict({k: np.asarray(v) for k, v in state.items()})
    eng.sim_cal = tuple(float(v) for v in ref_engine.sim_cal)
    if eng.mc.store == "device" and eng.mc.mode in ("bucket", "kernel"):
        eng.store.sync()
    return eng
