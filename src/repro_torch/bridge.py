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
from repro_torch.core.index import ClusteredDeviceIndex
from repro_torch.memo.specs import MemoSpec


def tree_to_torch(tree, device):
    """A nested dict of arrays (a JAX params pytree) → the same nesting
    of tensors on ``device``. Every mixer and channel block keeps the
    reference's keys and layouts, MLA's, MoE's, RG-LRU's and the
    encoder-decoder's included, so the trees cross unchanged: kimi_k2's
    plan, a ``single`` dense layer then a ``scan`` of MoE layers whose
    leaves are stacked on a leading axis (tests/test_torch_moe.py),
    recurrentgemma's ``scan`` of (rglru, rglru, attn) units then single
    RG-LRU layers (tests/test_torch_rglru.py), and whisper's encoder and
    decoder layers, each stack on a leading axis
    (tests/test_torch_encdec.py), cross leaf for leaf."""
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


def clustered_index_from_reference(ref_index, device
                                   ) -> ClusteredDeviceIndex:
    """A built reference ``ClusteredDeviceIndex`` → the port's, with the
    same layout: centroids, packed arrays, overflow table, host mirror
    and slot locations (k-means cannot match across frameworks bit for
    bit, so a search parity test carries the built layout across)."""
    r = ref_index
    t = ClusteredDeviceIndex(
        r.dim, n_clusters=r.n_clusters, nprobe=r.nprobe,
        kmeans_iters=r.kmeans_iters, rebuild_frac=r.rebuild_frac,
        balance_cap=r.balance_cap, seed=r.seed, device=device)
    t._host = np.array(r._host)
    t._slot_loc = np.array(r._slot_loc)
    t._n, t._built, t.n_rebuilds = r._n, r._built, r.n_rebuilds
    t._overflow = list(r._overflow)
    t._opos = dict(r._opos)
    t._overflow_base = r._overflow_base
    for name in ("_centroids", "_pvecs", "_pscales", "_pids", "_ovecs",
                 "_oscales", "_oids"):
        setattr(t, name, torch.from_numpy(np.array(getattr(r, name)))
                .to(device))
    t._republish()
    return t


def engine_from_reference(ref_engine, model, *, device,
                          spec: MemoSpec = None) -> MemoEngine:
    """A built reference ``MemoEngine`` (an encoder-decoder one too, whose
    store holds encoder APMs) → a port engine serving the same
    weights, embedder, store state and ``sim_cal`` on ``device`` (the
    store's device tier is re-materialized by a full sync; a clustered
    device index is then replaced by the reference's layout, carried
    across by ``clustered_index_from_reference``)."""
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
        ref_di, store = ref_engine.store.device_index, eng.store
        if isinstance(store.device_index, ClusteredDeviceIndex) \
                and type(ref_di).__name__ == "ClusteredDeviceIndex":
            di = clustered_index_from_reference(ref_di, store.device)
            di._registry_kind = "clustered"
            if store.index is store.device_index:
                store.index = di
            store.device_index = di
            store.publish()
    return eng
