"""The port's sharded memo store (``repro_torch/core/shard.py``) against
the JAX package's ``tests/test_shard.py``.

Every case of the reference's file runs here on the port: the host-index
guard, top-1 parity with the fetched codec rows, the ONE combine per
search (counted by patching ``shard._ALL_GATHER``), per-shard generation
publish, the hot set absorbing routing masks, shard-local eviction and
the centroid refresh. Store cases run at S = 1 and at S = 8 over
``StoreMesh((cpu,) * 8)``, which the reference runs only in a subprocess
(its device count locks at the first JAX init).

Against the reference: the S = 1 engine (both packages clamp to one
device) serves the same batches with equal hits and slots; and one
module fixture runs the reference's 8-way mesh in a subprocess, dumps
its state after the first full sync and the results of a fixed sequence
of searches, admissions, evictions and syncs, and the port replays that
sequence from the state carried across by
``bridge.sharded_store_from_reference`` (k-means cannot match across
frameworks bit for bit): slots, positions, generations, evictions,
spills, centroid refreshes and codec rows must be equal."""
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.shard as shard
from repro_torch.bridge import (clustered_index_from_reference,
                                engine_from_reference,
                                sharded_store_from_reference)
from repro_torch.core.faults import MemoStoreError
from repro_torch.core.shard import (ShardedMemoStore, ShardSnapshot,
                                    StoreMesh)
from repro_torch.memo import MemoSpec
from repro_torch.models import build_model
from test_torch_engine import _cfgs, _compare, _mid_threshold, _serve
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

APM = (2, 4, 4)
DIM = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _mesh(S):
    return StoreMesh((CPU,) * S)


def _entries(rng, n):
    """n unique, well-separated entries (the reference's recipe)."""
    apms = rng.random((n, *APM)).astype(np.float16)
    embs = rng.normal(0, 0.01, (n, DIM)).astype(np.float32)
    embs[:, 0] += 10.0 * np.arange(1, n + 1)
    return apms, embs


def _mk(S=1, **kw):
    kw.setdefault("index_kind", "exact")
    kw.setdefault("codec", "f16")
    kw.setdefault("capacity", 8)
    return ShardedMemoStore(APM, DIM, n_shards=S, mesh=_mesh(S), **kw)


def _fetch(s, q):
    di = s.device_index
    return di.search_fetch(torch.from_numpy(np.asarray(q, np.float32)),
                           args=di.search_args, parts=s.device_db.parts)


# ------------------------------------------------------------- guards

def test_rejects_host_device_index_kind():
    with pytest.raises(MemoStoreError, match="single-host"):
        _mk(index_kind="device")


def test_make_store_mesh_clamps_on_the_cpu():
    """The CPU is one device: any shard count clamps to S = 1, as the
    reference clamps past ``jax.device_count()``."""
    for n in (None, 1, 8):
        m = shard.make_store_mesh(n, "store", device="cpu")
        assert m.devices == (CPU,) and m.axis == "store"
    s = ShardedMemoStore(APM, DIM, n_shards=8, index_kind="exact",
                         device="cpu")
    assert s.n_shards == 1


# ------------------------------------------------- search + combines

@pytest.mark.parametrize("S", [1, 8])
def test_top1_parity_and_fetched_payload(S):
    """Every admitted entry finds ITSELF (global slot id through the
    combine) and ``search_fetch`` returns the winner's own codec rows."""
    rng = np.random.default_rng(0)
    s = _mk(S)
    apms, embs = _entries(rng, 12)
    slots = s.admit(apms, embs)
    s.sync(force_full=True)
    d2, got, rows = _fetch(s, embs)
    np.testing.assert_array_equal(got.numpy()[:, 0], slots)
    assert np.all(d2.numpy()[:, 0] < 0.1)
    dec = s.codec.decode_rows(rows).float().numpy()
    np.testing.assert_allclose(dec, apms.astype(np.float32), atol=1e-3,
                               rtol=0)
    _, idx = s.device_index.search(embs)          # host-compat (L2)
    np.testing.assert_array_equal(idx[:, 0], slots)


@pytest.mark.parametrize("S", [1, 8])
def test_search_fetch_makes_exactly_one_combine(monkeypatch, S):
    """Distances, slot ids AND codec rows move through ONE combine; so
    does a rows-free ``search_device``."""
    rng = np.random.default_rng(1)
    s = _mk(S)
    apms, embs = _entries(rng, 8)
    s.admit(apms, embs)
    s.sync(force_full=True)
    calls = []
    real = shard._ALL_GATHER

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(shard, "_ALL_GATHER", counting)
    _fetch(s, embs)
    assert len(calls) == 1
    assert len(calls[0][0]) == S           # one payload per shard
    calls.clear()
    s.device_index.search_device(torch.from_numpy(embs))
    assert len(calls) == 1


# -------------------------------------------------- publish + snapshots

@pytest.mark.parametrize("S", [1, 8])
def test_publish_carries_per_shard_snapshots(S):
    rng = np.random.default_rng(2)
    s = _mk(S)
    apms, embs = _entries(rng, 6)
    s.admit(apms, embs)
    s.sync(force_full=True)
    s.publish()
    snaps = s.shard_snapshots
    assert len(snaps) == s.n_shards == S
    assert all(isinstance(x, ShardSnapshot) for x in snaps)
    assert sum(x.live for x in snaps) == 6
    assert s.shard_occupancy().sum() == 6
    st = s.shard_stats()
    assert st["n_shards"] == S and sum(st["occupancy"]) == 6
    assert st["imbalance"] >= 1.0
    assert s.per_shard_budget_bytes == s._pos_per_shard * s.entry_nbytes


@pytest.mark.parametrize("S", [1, 8])
def test_delta_sync_bumps_touched_generations(S):
    rng = np.random.default_rng(3)
    s = _mk(S)
    apms, embs = _entries(rng, 6)
    s.admit(apms, embs)
    s.sync(force_full=True)
    s.publish()
    g0 = [x.generation for x in s.shard_snapshots]
    a2, e2 = _entries(rng, 2)
    e2[:, 0] += 200.0
    s.admit(a2, e2)
    assert s.sync()["kind"] == "delta"
    g1 = [x.generation for x in s.shard_snapshots]
    assert any(b > a for a, b in zip(g0, g1))
    assert sum(x.live for x in s.shard_snapshots) == 8


def test_snapshot_is_unchanged_across_a_sharded_delta_sync():
    """Copy-on-write: a held snapshot's tensors keep their values after
    a delta sync and a kill rewrite the touched shards."""
    rng = np.random.default_rng(4)
    s = _mk(4, capacity=32)
    apms, embs = _entries(rng, 20)
    s.admit(apms, embs)
    s.sync(force_full=True)
    snap = s.snapshot
    flat = [t.clone() for t in _leaves((snap.db_parts, snap.search_args,
                                        snap.lengths))]
    a2, e2 = _entries(rng, 5)
    e2[:, 0] += 0.03
    s.admit(a2, e2)
    s.evict(3)
    assert s.sync()["kind"] == "delta"
    assert s.snapshot is not snap
    for a, b in zip(flat, _leaves((snap.db_parts, snap.search_args,
                                   snap.lengths))):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for t in tree:
        out.extend(_leaves(t))
    return out


# -------------------------------------------------------------- hot set

@pytest.mark.parametrize("S", [1, 8])
def test_hot_set_absorbs_routing_mask(S):
    """A query masked away from every shard owning its entry is still
    served when the entry is in the replicated hot set."""
    rng = np.random.default_rng(4)
    s = _mk(S, hot_k=2, route_nprobe=1)
    apms, embs = _entries(rng, 8)
    slots = s.admit(apms, embs)
    s.sync(force_full=True)
    di = s.device_index
    # route everything to one far-off centroid owned by the last shard;
    # make slot[3] hot, and put it where that shard cannot see it
    far = np.full((1, DIM), 1e6, np.float32)
    di.set_centroids(far, np.full((1,), S - 1, np.int32))
    hot = 3
    H = max(1, di.hot_k)
    table = np.full((H, DIM), shard.TOMBSTONE, np.float32)
    hslots = np.full((H,), -1, np.int32)
    parts = [np.zeros((H,) + p.shape, p.dtype) for p in s.codec.parts]
    table[0] = embs[hot]
    hslots[0] = slots[hot]
    for dst, src in zip(parts, s.db.parts_at(np.asarray([slots[hot]]))):
        dst[0] = src[0]
    di.set_hot(table, hslots, tuple(parts))
    d2, idx = di.search_device(torch.from_numpy(embs[hot][None]))
    assert int(idx[0, 0]) == int(slots[hot])
    assert float(d2[0, 0]) < 0.1


@pytest.mark.parametrize("S", [1, 8])
def test_sync_refreshes_hot_set_by_reuse(S):
    rng = np.random.default_rng(5)
    s = _mk(S, hot_k=2)
    apms, embs = _entries(rng, 6)
    slots = s.admit(apms, embs)
    s.sync(force_full=True)
    di = s.device_index
    shape0 = (di._hot_table[0].shape, di._hot_slots[0].shape)
    s.db.get(np.asarray([slots[4], slots[4], slots[4], slots[1]]))
    s.admit(*_entries(np.random.default_rng(6), 1))  # dirty -> delta sync
    s.sync()
    di = s.device_index
    assert int(slots[4]) in set(di._hot_slots[0].tolist())
    assert (di._hot_table[0].shape, di._hot_slots[0].shape) == shape0


def test_probe_ties_take_the_lower_centroid_index():
    """Equal centroid distances at the ``route_nprobe`` edge: the port's
    stable sort takes the lower centroid index, as ``lax.top_k(-cd)``
    does (torch.topk leaves the order of equal values unspecified)."""
    rng = np.random.default_rng(7)
    s = _mk(2, hot_k=0, route_nprobe=1, capacity=16)
    apms, embs = _entries(rng, 8)
    slots = s.admit(apms, embs)
    s.sync(force_full=True)
    di = s.device_index
    q = embs[5][None]
    # two identical centroids: index 0 owned by the shard NOT holding the
    # entry, index 1 by the one holding it; the tie must go to index 0
    holder = s._slot_pos[int(slots[5])] // s._pos_per_shard
    cents = np.stack([embs[5], embs[5]]).astype(np.float32)
    for first in (1 - holder, holder):
        di.set_centroids(cents, np.asarray([first, 1 - first], np.int32))
        cd = np.asarray(-2.0 * q @ cents.T + (cents * cents).sum(1))
        _, jprobe = jax.lax.top_k(-jnp.asarray(cd), 1)
        assert int(jprobe[0, 0]) == 0
        d2, idx = di.search_device(torch.from_numpy(q))
        if first == holder:
            assert int(idx[0, 0]) == int(slots[5])
        else:                   # the entry's shard is masked away
            assert int(idx[0, 0]) != int(slots[5])


# ------------------------------------------------ centroid refresh

@pytest.mark.parametrize("S", [1, 8])
def test_centroid_refresh_trigger_and_fixed_shapes(S):
    rng = np.random.default_rng(5)
    s = _mk(S, refresh_spills=2)
    apms, embs = _entries(rng, 10)
    slots = s.admit(apms, embs)
    s.sync(force_full=True)
    shape0 = s._centroids_host.shape
    assert s.n_centroid_refreshes == 0
    pos0 = dict(s._slot_pos)
    s._spills_since_refresh = 2          # primed past the threshold
    a2, e2 = _entries(rng, 2)
    e2[:, 0] += 120.0
    new = s.admit(a2, e2)
    s.sync()
    assert s.n_centroid_refreshes == 1
    assert s._spills_since_refresh == 0
    assert s.shard_stats()["n_centroid_refreshes"] == 1
    assert s._centroids_host.shape == shape0
    assert all(s._slot_pos.get(k) == v for k, v in pos0.items()
               if k in s._slot_pos)
    _, idx = s.device_index.search(np.concatenate([embs, e2]))
    np.testing.assert_array_equal(idx[:, 0], np.concatenate([slots, new]))
    s._spills_since_refresh = 1
    s.sync(force_full=True)
    assert s._spills_since_refresh == 0
    assert s.n_centroid_refreshes == 1


def test_centroid_refresh_disabled_by_default():
    rng = np.random.default_rng(6)
    s = _mk()
    assert s.refresh_spills == 0
    apms, embs = _entries(rng, 6)
    s.admit(apms, embs)
    s.sync(force_full=True)
    s._spills_since_refresh = 10 ** 6
    a2, e2 = _entries(rng, 2)
    e2[:, 0] += 120.0
    s.admit(a2, e2)
    s.sync()
    assert s.n_centroid_refreshes == 0
    assert s.shard_stats()["n_centroid_refreshes"] == 0


# ---------------------------------------------------------- 8-way mesh

def test_eight_way_mesh_in_process(monkeypatch):
    """The reference's 8-way subprocess assertions, run in process on
    ``StoreMesh((cpu,) * 8)``: balanced occupancy, routed-search parity,
    one combine, selective generation bumps, shard-local eviction under
    skew and the centroid refresh it triggers."""
    N = 96
    rng = np.random.default_rng(0)
    apms, embs = _entries(rng, N)
    s = ShardedMemoStore(APM, DIM, n_shards=8, capacity=16, hot_k=4,
                         route_nprobe=2, index_kind="exact", codec="f16",
                         refresh_spills=6, mesh=_mesh(8))
    assert s.n_shards == 8
    slots = s.admit(apms, embs)
    s.sync(force_full=True)
    C0 = s._centroids_host.shape[0]
    st = s.shard_stats()
    occ = np.asarray(st["occupancy"])
    assert occ.sum() == N and (occ > 0).all(), occ
    assert st["imbalance"] <= 2.0, st
    d2, idx, rows = _fetch(s, embs)
    assert (idx.numpy()[:, 0] == slots).all()
    assert d2.numpy().max() < 0.1
    np.testing.assert_allclose(s.codec.decode_rows(rows).float().numpy(),
                               apms.astype(np.float32), atol=1e-3)
    calls = []
    real = shard._ALL_GATHER
    monkeypatch.setattr(shard, "_ALL_GATHER",
                        lambda *a, **k: (calls.append(a) or real(*a, **k)))
    _fetch(s, embs[:8])
    assert len(calls) == 1
    monkeypatch.setattr(shard, "_ALL_GATHER", real)
    g0 = np.asarray([x.generation for x in s.shard_snapshots])
    a2, e2 = apms[:3].copy(), embs[:3].copy()
    e2[:, 0] += 0.05
    s.admit(a2, e2)
    s.sync()
    g1 = np.asarray([x.generation for x in s.shard_snapshots])
    assert 1 <= int((g1 > g0).sum()) < 8, (g0, g1)
    ab = rng.random((40, *APM)).astype(np.float16)
    eb = rng.normal(0, 0.01, (40, DIM)).astype(np.float32)
    eb[:, 0] += 10.0
    s.admit(ab, eb)
    s.sync()
    assert s.n_shard_evictions + s.n_spills > 0
    live = int(s.db.live_mask[: len(s.db)].sum())
    assert s.shard_occupancy().sum() == live
    assert s.n_centroid_refreshes >= 1
    assert s._centroids_host.shape[0] == C0
    d3, _ = s.device_index.search(eb[:8])
    assert d3[:, 0].max() < 1.0


# ---------------------------- the reference's 8-way mesh, replayed

_REF8_CODE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax.numpy as jnp
from repro.core.shard import ShardedMemoStore

APM, DIM, N = (2, 4, 4), 8, 96
rng = np.random.default_rng(0)
apms = rng.random((N, *APM)).astype(np.float16)
embs = rng.normal(0, 0.01, (N, DIM)).astype(np.float32)
embs[:, 0] += 10.0 * np.arange(1, N + 1)
s = ShardedMemoStore(APM, DIM, n_shards=8, capacity=16, hot_k=4,
                     route_nprobe=2, index_kind="exact", codec="f16",
                     refresh_spills=6)
assert s.n_shards == 8
s.admit(apms, embs)
s.sync(force_full=True)

def attrs(s):
    return dict(
        state=s.state_dict(), pos_per_shard=s._pos_per_shard,
        pos_slot=np.array(s._pos_slot), slot_pos=dict(s._slot_pos),
        shard_free=[list(f) for f in s._shard_free],
        shard_hands=list(s._shard_hands),
        centroids=np.array(s._centroids_host),
        owner=np.array(s._owner_host), gens=np.array(s._shard_gens),
        n_shard_evictions=s.n_shard_evictions, n_spills=s.n_spills,
        spills_since=s._spills_since_refresh,
        n_refreshes=s.n_centroid_refreshes,
        hot=np.asarray(s.device_index._hot_slots),
        dev_lens=np.asarray(s._dev_lens), dirty=sorted(s._dirty),
        synced_n=s._synced_n,
        stats={k: int(v) for k, v in vars(s.stats).items()})

start = attrs(s)
steps = []
def search(q):
    di = s.device_index
    d2, idx, rows = di.search_fetch(jnp.asarray(q), args=di.search_args,
                                    parts=s.device_db.parts)
    return dict(d2=np.asarray(d2), idx=np.asarray(idx),
                rows=[np.asarray(r) for r in rows])

def step(name, q, op=None):
    if op is not None:
        op()
    out = attrs(s)
    out.pop("state")
    out.update(name=name, q=q, search=None if q is None else search(q))
    steps.append(out)

shifted = embs + rng.normal(0, 2.0, embs.shape).astype(np.float32)
step("first", np.concatenate([embs, shifted]))
a2, e2 = apms[:3].copy(), embs[:3].copy()
e2[:, 0] += 0.05
burst_a = rng.random((40, *APM)).astype(np.float16)
burst_e = rng.normal(0, 0.01, (40, DIM)).astype(np.float32)
burst_e[:, 0] += 10.0
far_a = rng.random((24, *APM)).astype(np.float16)
far_e = rng.normal(0, 0.01, (24, DIM)).astype(np.float32)
# a second region, off the first axis and irregularly spaced, so every
# query's nearest resident row wins by far more than an f32 rounding of
# the matmul-form distance (|q|^2 ~ 1e5 here)
far_e[:, 1] += 300.0 + 10.0 * np.arange(24) ** 1.3
reuse = rng.integers(0, N, 64)
# a tight cluster larger than a shard's positions: the full sync's
# packing spills its overflow to the emptiest shards
skew_a = rng.random((80, *APM)).astype(np.float16)
skew_e = rng.normal(0, 0.01, (80, DIM)).astype(np.float32)
skew_e[:, 0] += 505.0
ops = dict(
    near=lambda: (s.admit(a2, e2), s.sync()),
    burst=lambda: (s.admit(burst_a, burst_e), s.sync()),
    reuse_far=lambda: (s.note_reuse(reuse), s.admit(far_a, far_e),
                       s.sync()),
    evict=lambda: (s.evict(7), s.sync()),
    full=lambda: (s.admit(skew_a, skew_e), s.sync(force_full=True)))
inputs = dict(near=(a2, e2), burst=(burst_a, burst_e),
              reuse_far=(reuse, far_a, far_e), evict=7,
              full=(skew_a, skew_e))
# each reference search compiles its shard_map anew (~7 s): search after
# the steps whose routing matters most, compare state after every step
for name in ("near", "burst", "reuse_far", "evict", "full"):
    q = (np.concatenate([embs[:16], burst_e[:8], far_e[:8]])
         if name in ("burst", "full") else None)
    step(name, q, ops[name])
with open(sys.argv[1], "wb") as f:
    pickle.dump(dict(start=start, steps=steps, inputs=inputs,
                     final=s.state_dict()), f)
print("REF8-DUMPED")
"""


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    """The reference's 8-way store in a subprocess (~10 s): its state
    after the first full sync, the inputs and every step's results."""
    path = tmp_path_factory.mktemp("ref8") / "ref8.pkl"
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _REF8_CODE, str(path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert "REF8-DUMPED" in out.stdout, out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _as_reference(a):
    """A duck-typed reference store from the dump: the attributes
    ``sharded_store_from_reference`` reads."""
    ns = types.SimpleNamespace
    return ns(
        n_shards=8, apm_shape=APM, embed_dim=DIM, shard_axis="store",
        hot_k=4, route_nprobe=2, refresh_spills=6, index_kind="exact",
        budget_bytes=None, device_slack=1.0, index=ns(),
        codec=ns(name="f16", rank=None), cluster_crossover=4096,
        nprobe=16, n_clusters=None, eviction_kind="clock",
        state_dict=lambda: a["state"], _pos_per_shard=a["pos_per_shard"],
        _pos_slot=a["pos_slot"], _slot_pos=a["slot_pos"],
        _shard_free=a["shard_free"], _shard_hands=a["shard_hands"],
        _centroids_host=a["centroids"], _owner_host=a["owner"],
        _shard_gens=a["gens"], n_shard_evictions=a["n_shard_evictions"],
        n_spills=a["n_spills"], _spills_since_refresh=a["spills_since"],
        n_centroid_refreshes=a["n_refreshes"], stats=ns(**a["stats"]),
        device_index=ns(_hot_slots=a["hot"]), _dev_lens=a["dev_lens"],
        _dirty=set(a["dirty"]), _synced_n=a["synced_n"])


@pytest.fixture(scope="module")
def replay(ref8):
    """The port replays the reference's sequence from the carried state;
    returns [(reference step, port results)]."""
    s = sharded_store_from_reference(_as_reference(ref8["start"]),
                                     _mesh(8))
    inp = ref8["inputs"]
    ops = dict(
        near=lambda: (s.admit(*inp["near"]), s.sync()),
        burst=lambda: (s.admit(*inp["burst"]), s.sync()),
        reuse_far=lambda: (s.note_reuse(inp["reuse_far"][0]),
                           s.admit(*inp["reuse_far"][1:]), s.sync()),
        evict=lambda: (s.evict(inp["evict"]), s.sync()),
        full=lambda: (s.admit(*inp["full"]), s.sync(force_full=True)))
    out = []
    for ref in ref8["steps"]:
        if ref["name"] in ops:
            ops[ref["name"]]()
        found = {}
        if ref["q"] is not None:
            d2, idx, rows = _fetch(s, ref["q"])
            found = dict(d2=d2.numpy(), idx=idx.numpy(),
                         rows=[r.numpy() for r in rows])
        out.append((ref, dict(found, 
            pos_slot=s._pos_slot.copy(), gens=s._shard_gens.copy(),
            shard_free=[list(f) for f in s._shard_free],
            shard_hands=list(s._shard_hands),
            n_shard_evictions=s.n_shard_evictions, n_spills=s.n_spills,
            n_refreshes=s.n_centroid_refreshes, owner=s._owner_host.copy(),
            centroids=s._centroids_host.copy(),
            hot=s.device_index._hot_slots[0].numpy().copy(),
            n_evicted=s.stats.n_evicted, state=s.state_dict())))
    return out


def test_replay_covers_spills_evictions_and_refreshes(replay):
    """The sequence exercises what it is meant to compare: shard-local
    evictions, centroid refreshes, a full sync whose packing spills, and
    generations bumped on some shards only."""
    last = replay[-1][0]
    assert last["n_shard_evictions"] > 0 and last["n_refreshes"] >= 1
    assert last["n_spills"] > 0
    assert [r["name"] for r, _ in replay] == ["first", "near", "burst",
                                              "reuse_far", "evict", "full"]
    g0, g1 = replay[0][0]["gens"], replay[1][0]["gens"]
    assert 1 <= int((g1 > g0).sum()) < 8


@pytest.mark.parametrize("what", ["slots", "positions", "generations",
                                  "counters", "routing", "rows"])
def test_replay_matches_the_reference_bit_for_bit(replay, what):
    searched = 0
    for ref, got in replay:
        msg = f"step {ref['name']}"
        if what in ("slots", "rows") and ref["search"] is None:
            continue
        searched += 1
        if what == "slots":
            np.testing.assert_array_equal(got["idx"], ref["search"]["idx"],
                                          err_msg=msg)
        elif what == "positions":
            np.testing.assert_array_equal(got["pos_slot"], ref["pos_slot"],
                                          err_msg=msg)
            assert got["shard_free"] == [list(map(int, f))
                                         for f in ref["shard_free"]], msg
            assert got["shard_hands"] == list(ref["shard_hands"]), msg
        elif what == "generations":
            np.testing.assert_array_equal(got["gens"], ref["gens"],
                                          err_msg=msg)
        elif what == "counters":
            assert (got["n_shard_evictions"], got["n_spills"],
                    got["n_refreshes"], got["n_evicted"]) == (
                ref["n_shard_evictions"], ref["n_spills"],
                ref["n_refreshes"], ref["stats"]["n_evicted"]), msg
        elif what == "routing":
            np.testing.assert_array_equal(got["owner"], ref["owner"],
                                          err_msg=msg)
            np.testing.assert_allclose(got["centroids"], ref["centroids"],
                                       rtol=1e-6, atol=1e-5, err_msg=msg)
            np.testing.assert_array_equal(got["hot"], ref["hot"],
                                          err_msg=msg)
        else:
            for a, b in zip(got["rows"], ref["search"]["rows"]):
                assert a.tobytes() == b.tobytes(), msg
            # the matmul-form distance rounds at f32 of (|q| + |q - d|)^2
            scale = (np.sqrt((ref["q"] ** 2).sum(1, keepdims=True))
                     + np.sqrt(np.maximum(ref["search"]["d2"], 0))) ** 2
            tol = 1e-6 * scale
            assert (np.abs(got["d2"] - ref["search"]["d2"]) <= tol).all(), \
                msg
    assert searched >= 3


def test_replay_host_tier_matches_the_reference(replay, ref8):
    """After the whole sequence both host tiers are equal array for
    array (``state_dict``: arenas, liveness, reuse counts, free list,
    CLOCK hand)."""
    got, ref = replay[-1][1]["state"], ref8["final"]
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]),
                                      err_msg=k)


# ------------------------------------------------------- engine parity

@pytest.fixture(scope="module")
def sharded_built():
    """The reference's S = 1 sharded engine (as ``tests/test_shard.py``
    builds it) carried into the port, plus queries."""
    from repro.core.engine import MemoEngine as JaxEngine
    from repro.data import TemplateCorpus
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    cfg, jcfg = _cfgs()
    jm = jax_build_model(jcfg, layer_loop="unroll")
    jeng = JaxEngine(jm, jm.init(jax.random.PRNGKey(0)), JaxSpec.flat(
        threshold=0.6, embed_steps=40, mode="bucket", shards=1,
        shard_hot=8))
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=32, n_templates=6,
                            slot_fraction=0.2)
    jeng.build(jax.random.PRNGKey(1),
               [{"tokens": jnp.asarray(corpus.sample(16)[0])}
                for _ in range(3)])
    teng = engine_from_reference(jeng, build_model(cfg, device="cpu"),
                                 device="cpu")
    return jeng, teng, [corpus.sample(8)[0] for _ in range(2)], cfg


def test_engine_builds_sharded_store_from_spec(sharded_built):
    jeng, teng, _, _ = sharded_built
    assert isinstance(teng.store, ShardedMemoStore)
    assert teng.store.hot_k == 8 and teng.store.n_shards == 1
    assert getattr(teng.store.device_index, "is_sharded", False)
    np.testing.assert_array_equal(teng.store._pos_slot,
                                  jeng.store._pos_slot)


@pytest.mark.parametrize("thr", [-1e9, 0.6, 1e9])
@pytest.mark.parametrize("mode", ["bucket", "kernel"])
def test_engine_sharded_matches_select(sharded_built, thr, mode):
    """The sharded tier serves like the reference's sharded tier (equal
    hits and slots, logits within 1e-4) and like the port's own select
    path (logits within 2e-3, the reference test's tolerance)."""
    jeng, teng, queries, _ = sharded_built
    jeng.mc.mode = teng.mc.mode = mode
    toks = queries[0]
    if thr == 0.6:
        thr = _mid_threshold(jeng, {"tokens": jnp.asarray(toks)})
    hits = _compare(jeng, teng, {"tokens": toks}, thr)
    teng.mc.mode = "select"
    try:
        ref, _ = teng.infer({"tokens": toks}, threshold=thr)
    finally:
        teng.mc.mode = mode
    out, st = teng.infer({"tokens": toks}, threshold=thr)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)
    if thr == -1e9:
        assert hits.all() and st.memo_rate == 1.0
    if thr == 1e9:
        assert not hits.any() and st.memo_rate == 0.0


@pytest.fixture(scope="module")
def eight_way_engines(sharded_built):
    """The same entries served by a port engine with a flat device
    index and by port engines over ``StoreMesh((cpu,) * 8)`` (the engine
    reaches it through a patched ``make_store_mesh``): one routed to
    every centroid, one at the default routing."""
    jeng, _, queries, cfg = sharded_built
    real = shard.make_store_mesh
    shard.make_store_mesh = lambda n=None, axis="store", device=None: \
        _mesh(8)
    try:
        model = build_model(cfg, device="cpu")
        engs = {}
        for name, kw in (("flat", dict(shards=0, device_index="flat")),
                         ("full", dict(shards=8, shard_route_nprobe=10 ** 6)),
                         ("routed", dict(shards=8))):
            spec = MemoSpec.from_dict(jeng.mc.to_dict())
            for k, v in kw.items():
                setattr(spec, k, v)
            engs[name] = engine_from_reference(jeng, model, device="cpu",
                                               spec=spec)
    finally:
        shard.make_store_mesh = real
    return engs, queries


@pytest.mark.parametrize("mode", ["bucket", "kernel"])
def test_eight_way_engine_matches_flat_at_full_routing(eight_way_engines,
                                                       mode):
    """With every centroid probed, 8 shards on the CPU give the flat
    index's hits and slots bit for bit and its logits within 1e-4."""
    engs, queries = eight_way_engines
    assert engs["full"].store.n_shards == 8
    flat, full = engs["flat"], engs["full"]
    flat.mc.mode = full.mc.mode = mode
    batch = {"tokens": queries[1]}
    thr = _mid_threshold(flat, batch)
    fl, fp = _serve(flat, batch, thr)
    sl, sp = _serve(full, batch, thr)
    for (li, _, fh, fi), (_, _, sh, si) in zip(fp, sp):
        np.testing.assert_array_equal(sh, fh, err_msg=f"hits {li}")
        np.testing.assert_array_equal(si[fh], fi[fh], err_msg=f"slots {li}")
        np.testing.assert_array_equal(si, fi, err_msg=f"slots {li}")
    np.testing.assert_allclose(sl, fl, rtol=0, atol=1e-4)


def test_eight_way_default_routing_serves(eight_way_engines):
    """At the default ``route_nprobe`` routing may send a query past its
    nearest entry; every winner it returns is still a live slot whose
    distance is no better than the flat index's."""
    engs, queries = eight_way_engines
    flat, routed = engs["flat"], engs["routed"]
    flat.mc.mode = routed.mc.mode = "bucket"
    batch = {"tokens": queries[1]}
    _, fp = _serve(flat, batch, -1e9)
    _, rp = _serve(routed, batch, -1e9)
    live = routed.store.db.live_mask
    for (_, fs, _, _), (_, rs, _, ri) in zip(fp, rp):
        assert live[ri].all()
        assert (rs <= fs + 1e-5).all()      # sims fall with distance


# ------------------------------------------------- the mesh fallback

@pytest.mark.parametrize("S, n", [(3, 50), (4, 64), (8, 5)])
def test_mesh_search_matches_one_device(S, n):
    """``mesh_search`` over a row-split table (uneven splits too) gives
    the one-device top-1, ties to the lower row."""
    rng = np.random.default_rng(S)
    table = torch.from_numpy(rng.normal(0, 1, (n, DIM)).astype(np.float32))
    table[n // 2] = table[1]                 # a tie across shards
    q = torch.cat([table[:7] + 0.01, table[1:2]])
    d2, idx = shard.mesh_search(table, q, _mesh(S))
    from repro_torch.kernels.nn_search.ref import nn_search_ref
    rd, ri = nn_search_ref(q, table)
    assert torch.equal(idx, ri)
    torch.testing.assert_close(d2, rd)


def test_store_with_a_mesh_searches_through_mesh_search(monkeypatch):
    """``MemoStore(mesh=...)``: the flat device index (and the 'device'
    host index) search through ``mesh_search`` with equal results."""
    from repro_torch.core.store import MemoStore
    rng = np.random.default_rng(9)
    apms, embs = _entries(rng, 30)
    stores = [MemoStore(APM, DIM, index_kind=k, capacity=8, mesh=m,
                        device_index_kind="flat")
              for k, m in (("exact", None), ("exact", _mesh(4)),
                           ("device", _mesh(3)))]
    calls = []
    real = shard._ALL_GATHER
    monkeypatch.setattr(shard, "_ALL_GATHER",
                        lambda *a, **k: (calls.append(a) or real(*a, **k)))
    out = []
    for st in stores:
        st.admit(apms, embs)
        st.sync()
        view = st.snapshot
        out.append(view.index.search_device(torch.from_numpy(embs),
                                            args=view.search_args)[1])
    assert len(calls) == 2
    for o in out[1:]:
        assert torch.equal(o, out[0])


def test_clustered_table_matches_the_reference():
    """``ClusteredDeviceIndex.table``: the reference's lazy f32 copy of
    the host mirror on a carried-across layout, counted in
    ``transfer_bytes`` once per change; its mesh search equals the
    packed search's exact answer on well-separated rows."""
    from repro.core.index import ClusteredDeviceIndex as JaxClustered
    rng = np.random.default_rng(10)
    _, embs = _entries(rng, 40)
    jdi = JaxClustered(DIM, n_clusters=4, nprobe=2, capacity=48)
    jdi.add(embs)
    jdi.rebuild()
    tdi = clustered_index_from_reference(jdi, CPU)
    b0 = tdi.transfer_bytes
    t = tdi.table
    np.testing.assert_array_equal(t.numpy(), np.asarray(jdi.table))
    assert tdi.transfer_bytes - b0 == np.asarray(jdi.table).nbytes
    assert tdi.table is t                          # cached until a change
    tdi.assign([3], embs[3:4] + 1.0)
    assert tdi.table is not t and float(tdi.table[3, 0]) == embs[3, 0] + 1
    assert float(t[3, 0]) == embs[3, 0]            # the old copy kept
    tdi.mesh = _mesh(4)
    _, idx = tdi.search_device(torch.from_numpy(embs))
    exp = np.arange(40)
    exp[3] = 3
    np.testing.assert_array_equal(idx.numpy()[:, 0], exp)


# ------------------------------------------------------ save and load

def test_sharded_session_save_load_serves_the_same(sharded_built,
                                                   tmp_path):
    """A sharded session saved and loaded rebuilds its layout by a full
    sync on load and serves the same hits, slots and logits."""
    from repro_torch.memo.session import MemoSession
    _, teng, queries, cfg = sharded_built
    teng.mc.mode = "bucket"
    sess = MemoSession(teng)
    path = str(tmp_path / "s.npz")
    sess.save(path)
    loaded = MemoSession.load(path, build_model(cfg, device="cpu"),
                              teng.params, device="cpu")
    assert isinstance(loaded.store, ShardedMemoStore)
    assert loaded.store.hot_k == teng.store.hot_k
    batch = {"tokens": queries[1]}
    thr = _mid_threshold(teng, batch)
    al, ap = _serve(teng, batch, thr)
    bl, bp = _serve(loaded.engine, batch, thr)
    for (_, _, ah, ai), (_, _, bh, bi) in zip(ap, bp):
        np.testing.assert_array_equal(bh, ah)
        np.testing.assert_array_equal(bi, ai)
    np.testing.assert_allclose(bl, al, rtol=0, atol=1e-5)


def test_memo_server_keeps_a_held_sharded_snapshot(sharded_built,
                                                   monkeypatch):
    """``MemoServer`` with asynchronous maintenance over 8 CPU shards: a
    batch's ``run_layers`` holds its snapshot while the worker admits
    another batch's misses and delta-syncs them into the shards; every
    held tensor (each shard's arenas, tables, norms and slot maps, the
    replicated routing and hot set, the lengths) keeps its values, and
    the new snapshot finds the admitted rows."""
    from repro_torch.memo.session import MemoSession
    jeng, _, queries, cfg = sharded_built
    monkeypatch.setattr(shard, "make_store_mesh",
                        lambda n=None, axis="store", device=None: _mesh(8))
    spec = MemoSpec.from_dict(jeng.mc.to_dict())
    spec.shards, spec.mode, spec.admit, spec.admit_every = 8, "bucket", \
        True, 1
    eng = engine_from_reference(jeng, build_model(cfg, device="cpu"),
                                device="cpu", spec=spec)
    store = eng.store
    assert store.n_shards == 8
    eng.mc.threshold = 1e9                         # every row misses
    admitted, real_admit = [], store.admit

    def admit(*a, **k):
        slots = real_admit(*a, **k)
        admitted.append(slots)
        return slots
    store.admit = admit
    with MemoSession(eng).serve(buckets=(32,), max_batch=8,
                                async_maintenance=True) as srv:
        prep = eng.prepare_batch({"tokens": queries[0][:3]},
                                 sync_store=False)
        eng.run_layers(prep)
        _, _, payload = eng.finalize(prep)
        prep = eng.prepare_batch({"tokens": queries[1][:3]},
                                 sync_store=False)
        view = prep.view
        held = _leaves((view.db_parts, view.search_args, view.lengths))
        clones = [t.clone() for t in held]
        deltas, gens = store.stats.n_delta_syncs, store._shard_gens.copy()
        eng.run_layers(prep)
        srv._enqueue_payload(payload)
        srv.drain_maintenance()
        eng.finalize(prep)
        assert not srv.maintenance_errors
    assert store.stats.n_delta_syncs > deltas
    assert store.snapshot.generation > view.generation
    assert (store._shard_gens >= gens).all() \
        and (store._shard_gens > gens).any()
    for c, t in zip(clones, held):
        assert torch.equal(c, t)
    new = store.snapshot
    admitted = np.concatenate(admitted)
    assert admitted.size > 0
    q = torch.from_numpy(store.embeddings_at(admitted))
    _, idx = new.index.search_device(q, args=new.search_args)
    np.testing.assert_array_equal(idx.numpy()[:, 0], admitted)


def test_host_kernel_path_takes_rows_from_the_host_arena(eight_way_engines):
    """The host-synchronous kernel path over 8 shards (positions are not
    slots there) gathers the matched rows from the host arena by slot:
    its logits equal the fast path's at full routing."""
    engs, queries = eight_way_engines
    eng = engs["full"]
    assert not np.array_equal(
        eng.store._pos_slot[eng.store._pos_slot >= 0],
        np.sort(eng.store._pos_slot[eng.store._pos_slot >= 0]))
    batch = {"tokens": queries[0]}
    eng.mc.mode = "kernel"
    fast, st_fast = eng.infer(batch, threshold=-1e9)
    eng.mc.device_fast_path = False
    try:
        host, st_host = eng.infer(batch, threshold=-1e9)
    finally:
        eng.mc.device_fast_path = None
    assert st_fast.memo_rate == st_host.memo_rate == 1.0
    np.testing.assert_allclose(host.numpy(), fast.numpy(), rtol=0,
                               atol=1e-5)
