"""Carry JAX-side state into the port: numpy arrays in, tensors on a
given device out. The reference's parameter trees use the same keys and
layouts as the port's, so the bridge is a name map; the reference
objects are read through their attributes (duck typing), so nothing
here imports JAX or the reference package.

Random init and embedder training cannot match across frameworks, so a
parity test builds one reference engine and serves its exact state in
both packages through ``engine_from_reference``. k-means cannot match
bit for bit either, so a built clustered index or sharded store carries
its layout across (``clustered_index_from_reference``,
``sharded_store_from_reference``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.embedding import Embedder
from repro_torch.core.engine import MemoEngine
from repro_torch.core.index import ClusteredDeviceIndex
from repro_torch.core.store import StoreStats
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


def sharded_store_from_reference(ref_store, mesh, *, store=None):
    """A built reference ``ShardedMemoStore`` → the port's over ``mesh``
    (a ``shard.StoreMesh`` of the same shard count), with the same state:
    the host tier (``state_dict``), the positions (``_pos_slot``), the
    centroids and their owners, the hot set, the free lists, the CLOCK
    hands, the generations, the counters and the device lengths. The
    device tier is then uploaded from that layout, not re-fit, so the two
    stores search, admit, evict, spill and refresh alike from here on.
    ``store``: a port store already holding the reference's host tier
    (``engine_from_reference``'s), else one is made here."""
    from repro_torch.core.shard import ShardedMemoStore
    r = ref_store
    if int(r.n_shards) != mesh.size:
        raise ValueError(f"the reference store has {r.n_shards} shards, "
                         f"the mesh {mesh.size}")
    if store is None:
        state = {k: np.asarray(v) for k, v in r.state_dict().items()}
        store = ShardedMemoStore(
            tuple(r.apm_shape), int(r.embed_dim), shard_axis=r.shard_axis,
            hot_k=r.hot_k, route_nprobe=r.route_nprobe,
            refresh_spills=r.refresh_spills, mesh=mesh,
            index_kind=r.index_kind, budget_bytes=r.budget_bytes,
            capacity=max(1, int(np.asarray(state["n"]))),
            device_slack=r.device_slack,
            n_lists=getattr(r.index, "n_lists", None),
            codec=r.codec.name, apm_rank=getattr(r.codec, "rank", None),
            cluster_crossover=r.cluster_crossover, nprobe=r.nprobe,
            n_clusters=r.n_clusters, eviction=r.eviction_kind)
        store.load_state_dict(state)
    with store._lock:
        store._pos_per_shard = int(r._pos_per_shard)
        store._pos_slot = np.array(r._pos_slot, np.int64)
        store._slot_pos = {int(k): int(v) for k, v in r._slot_pos.items()}
        store._shard_free = [[int(p) for p in f] for f in r._shard_free]
        store._shard_hands = [int(h) for h in r._shard_hands]
        store._centroids_host = np.array(r._centroids_host, np.float32)
        store._owner_host = np.array(r._owner_host, np.int32)
        store._shard_gens = np.array(r._shard_gens, np.int64)
        for name in ("n_shard_evictions", "n_spills",
                     "_spills_since_refresh", "n_centroid_refreshes"):
            setattr(store, name, int(getattr(r, name)))
        store.stats = StoreStats(**{
            k: int(getattr(r.stats, k)) for k in vars(StoreStats())
            if hasattr(r.stats, k)})
        n = len(store.db)
        store._upload_layout_locked(n)
        store._dev_lens = torch.from_numpy(
            np.array(r._dev_lens, np.int32)).to(store.device)
        hot = np.asarray(r.device_index._hot_slots).reshape(-1)
        store._refresh_hot_locked(take=hot[hot >= 0])
        store._dirty = {int(s) for s in r._dirty}
        store._synced_n = int(r._synced_n)
        store.device_generation = store.generation
        store._publish_locked()
    return store


def engine_from_reference(ref_engine, model, *, device,
                          spec: MemoSpec = None) -> MemoEngine:
    """A built reference ``MemoEngine`` (an encoder-decoder one too, whose
    store holds encoder APMs) → a port engine serving the same
    weights, embedder,     store state and ``sim_cal`` on ``device`` (the
    store's device tier is re-materialized by a full sync; a clustered
    device index is then replaced by the reference's layout, carried
    across by ``clustered_index_from_reference``; a sharded store of the
    reference's shard count takes its layout through
    ``sharded_store_from_reference``)."""
    eng = MemoEngine(model, tree_to_torch(ref_engine.params, device),
                     spec if spec is not None
                     else spec_from_reference(ref_engine.mc))
    eng.embedder = embedder_from_reference(ref_engine.embedder, device)
    state = ref_engine.store.state_dict()
    eng.store = eng._make_store(tuple(ref_engine.store.apm_shape),
                                capacity=max(1, int(state["n"])))
    eng.store.load_state_dict({k: np.asarray(v) for k, v in state.items()})
    eng.sim_cal = tuple(float(v) for v in ref_engine.sim_cal)
    n_shards = getattr(eng.store, "n_shards", None)
    if n_shards is not None \
            and getattr(ref_engine.store, "n_shards", None) == n_shards \
            and ref_engine.store.device_db is not None:
        sharded_store_from_reference(ref_engine.store, eng.store.shard_mesh,
                                     store=eng.store)
    elif eng.mc.store == "device" and eng.mc.mode in ("bucket", "kernel"):
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
