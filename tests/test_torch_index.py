"""The port's clustered device index, host IVF index and k-means against
the JAX package's (``core/index.py``), on the CPU at small sizes.

The k-means assignment is a float32 product in both packages, but XLA
and torch sum it in different orders, so ``argmin`` may flip on a near
tie and the centroids drift apart from there. The tests therefore hold
the search and the build apart:

* the search — a built reference layout carried across
  (``bridge.clustered_index_from_reference``) must give the reference's
  ids on every query whose runner-up lies more than ``MARGIN`` of its d²
  behind the best (the count excluded is printed), with d² within
  ``D2_RTOL`` of the matmul form's scale (‖q‖² + ‖d‖²);
* the build — the port's own rebuild on the same data and seeds: the
  share of points k-means assigns alike and the centroid error are
  printed, and recall@1 against the exact index must be no worse than
  the reference's. Given the reference's k-means output, the port's
  balance-capped packing must be the reference's exactly.

The reference's clustered cases of ``tests/test_codec.py`` are ported
one for one, with a copy-on-write check of the clustered search tuple
a snapshot holds."""
import numpy as np
import pytest
import torch

from repro.core import index as J
from repro.core.store import MemoStore as JaxStore
from repro_torch.bridge import clustered_index_from_reference
from repro_torch.core import index as T
from repro_torch.core.index import (ClusteredDeviceIndex, ExactIndex,
                                    IVFIndex, recall_at_1)
from repro_torch.core.store import MemoStore
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MARGIN = 1e-4       # runner-up behind the best by more than this of its d²
D2_RTOL = 1e-5      # of ‖q‖² + ‖d‖²: the matmul form's rounding scale
# the seeds of the recall comparison (200: the reference's own recall
# bound of 0.95 fails there; the port is held to the reference, not to it)
BUILD_SEEDS = (0, 1, 2, 3, 4, 5, 6, 7, 200, 201)


def _serving_data(seed):
    """The reference's recall-property data: a DB around a few centers,
    a request batch near a handful of stored rows (the memo-hit case)."""
    rng = np.random.default_rng(seed)
    n_centers = int(rng.integers(4, 24))
    dim = int(rng.choice([16, 32, 64]))
    centers = rng.normal(size=(n_centers, dim)) * 5
    db = (centers[rng.integers(0, n_centers, 1500)]
          + rng.normal(size=(1500, dim))).astype(np.float32)
    n_templates = int(rng.integers(1, 9))
    rows = db[rng.integers(0, 1500, n_templates)]
    q = (rows[rng.integers(0, n_templates, 64)]
         + 0.1 * rng.normal(size=(64, dim))).astype(np.float32)
    return db, q, dim


def _apm_batch(rng, n, apm_shape):
    return rng.random((n, *apm_shape)).astype(np.float16)


# ------------------------------------------- ported from tests/test_codec.py
def test_store_flips_flat_to_clustered_at_crossover():
    apm_shape, dim = (1, 4, 4), 8
    s = MemoStore(apm_shape, dim, capacity=4, cluster_crossover=12)
    rng = np.random.default_rng(6)

    def batch(n, off):
        embs = rng.normal(0, 0.01, (n, dim)).astype(np.float32)
        embs[:, 0] += 10.0 * (off + np.arange(n))
        return _apm_batch(rng, n, apm_shape), embs

    s.admit(*batch(6, 1))
    s.sync()
    assert type(s.device_index).__name__ == "DeviceIndex"
    s.admit(*batch(10, 100))
    assert s.sync()["kind"] == "full"
    assert isinstance(s.device_index, ClusteredDeviceIndex)
    assert s.device_index.n_rebuilds == 1       # built on the sync
    assert s.snapshot.search_args is s.device_index.search_args
    # device search still finds every live entry (near-dup regime)
    q = torch.from_numpy(s._embs_host[: len(s.db)])
    _, idx = s.device_index.search_device(q)
    np.testing.assert_array_equal(idx.numpy()[:, 0], np.arange(len(s.db)))


def test_clustered_sync_routes_evictions_through_remove():
    """Evicted slots are tombstoned by remove(), not assign(): an assign
    would append the tombstone row to the overflow buffer and count
    toward the rebuild trigger."""
    apm_shape, dim = (1, 4, 4), 8
    s = MemoStore(apm_shape, dim, capacity=4, cluster_crossover=1)
    rng = np.random.default_rng(11)
    embs = rng.normal(0, 0.01, (12, dim)).astype(np.float32)
    embs[:, 0] += 10.0 * np.arange(1, 13)
    slots = s.admit(_apm_batch(rng, 12, apm_shape), embs)
    s.sync()
    di = s.device_index
    assert isinstance(di, ClusteredDeviceIndex)
    rebuilds0 = di.n_rebuilds
    ev = s.evict(3)
    assert s.sync()["kind"] == "delta"
    assert not any(int(e) in di._opos for e in ev)
    assert di.n_rebuilds == rebuilds0
    for e in ev:
        _, idx = di.search(embs[list(slots).index(e)][None], 1)
        assert int(idx[0, 0]) != int(e)


def test_clustered_lifecycle_assign_remove_topk():
    rng = np.random.default_rng(7)
    db = rng.normal(size=(600, 32)).astype(np.float32)
    cl = ClusteredDeviceIndex(32, nprobe=6)
    cl.add(db)
    cl.rebuild()
    # fresh admissions are findable at once (overflow buffer, no rebuild)
    rebuilds0 = cl.n_rebuilds
    extra = rng.normal(size=(4, 32)).astype(np.float32) + 50.0
    cl.assign(np.arange(600, 604), extra)
    assert cl.n_rebuilds == rebuilds0
    _, idx = cl.search(extra, 1)
    np.testing.assert_array_equal(idx[:, 0], np.arange(600, 604))
    cl.remove([600])
    _, idx = cl.search(extra[:1], 1)
    assert int(idx[0, 0]) != 600
    d, i = cl.search(db[:5], 3)
    assert i.shape == (5, 3) and i.dtype == np.int32
    assert (d[:, 0] <= d[:, 1]).all() and (d[:, 1] <= d[:, 2]).all()
    np.testing.assert_array_equal(i[:, 0], np.arange(5))


def test_clustered_rebuild_absorbs_overflow():
    rng = np.random.default_rng(8)
    db = rng.normal(size=(200, 16)).astype(np.float32)
    cl = ClusteredDeviceIndex(16, rebuild_frac=0.1)
    cl.add(db)
    cl.search(db[:1], 1)                        # the first build
    assert cl.n_rebuilds == 1
    extra = rng.normal(size=(40, 16)).astype(np.float32)
    cl.assign(np.arange(200, 240), extra)       # 40 > 0.1·N → rebuild
    assert cl.n_rebuilds > 1 and len(cl._overflow) == 0
    _, idx = cl.search(extra, 1)
    np.testing.assert_array_equal(idx[:, 0], np.arange(200, 240))


def test_clustered_search_args_renew_on_rebuild():
    """The reference's retrace test: a rebuild publishes a new tuple of
    new shapes, and a search through it finds the same rows."""
    rng = np.random.default_rng(9)
    db = rng.normal(size=(300, 16)).astype(np.float32)
    cl = ClusteredDeviceIndex(16, nprobe=4)
    cl.add(db)
    q = torch.from_numpy(db[:4])
    args1 = cl.search_args
    assert cl.search_args is args1              # stable while unchanged
    np.testing.assert_array_equal(
        cl.search_device(q, args=args1)[1].numpy()[:, 0], np.arange(4))
    cl.assign(np.arange(300, 364), rng.normal(size=(64, 16)).astype(
        np.float32))
    cl.rebuild()
    args2 = cl.search_args
    assert args2 is not args1
    assert tuple(args2[1].shape) != tuple(args1[1].shape)
    np.testing.assert_array_equal(
        cl.search_device(q, args=args2)[1].numpy()[:, 0], np.arange(4))


def test_empty_clustered_index_is_a_searchable_miss():
    cl = ClusteredDeviceIndex(8)
    cl.add(np.ones((3, 8), np.float32))
    cl.remove([0, 1, 2])
    cl.rebuild()
    d2, idx = cl.search_device(torch.zeros(2, 8))
    assert (idx.numpy() == -1).all() and (d2.numpy() >= 1e29).all()


# --------------------------------------------------- held to the reference
def _bridged(seed):
    db, q, dim = _serving_data(seed)
    ref = J.ClusteredDeviceIndex(dim, seed=seed % 17)
    ref.add(db)
    ref.rebuild()
    # post-build admissions: the overflow buffer and a patched packed row
    rng = np.random.default_rng(seed + 1)
    ref.assign([3, 1500, 1501], db[[5, 6, 7]] + 0.05 * rng.normal(
        size=(3, dim)).astype(np.float32))
    ref.remove([9])
    rand = rng.normal(size=(32, dim)).astype(np.float32) * 5
    return ref, clustered_index_from_reference(ref, "cpu"), \
        np.concatenate([q, rand])


@pytest.mark.parametrize("seed", [0, 4, 200])
def test_bridged_layout_search_matches_reference(seed):
    ref, port, q = _bridged(seed)
    import jax.numpy as jnp
    jd2, jidx = (np.asarray(a) for a in ref.search_device(jnp.asarray(q)))
    td2, tidx = (a.numpy() for a in port.search_device(torch.from_numpy(q)))
    # the margin: the reference's own best distinct-id runner-up
    kd2, kidx = (np.asarray(a) for a in ref.search_device(jnp.asarray(q),
                                                         k=4))
    runner = np.array([min([d for d, i in zip(kd2[b], kidx[b])
                            if i != kidx[b, 0]] or [np.inf])
                       for b in range(len(q))])
    clear = runner - kd2[:, 0] > MARGIN * np.abs(runner)
    print(f"seed {seed}: {int((~clear).sum())}/{len(q)} queries within "
          f"the margin, excluded")
    np.testing.assert_array_equal(tidx[clear], jidx[clear])
    scale = (q * q).sum(1)[:, None] + np.abs(jd2)
    assert (np.abs(td2 - jd2) <= D2_RTOL * scale).all()


def test_clustered_packing_equals_reference_given_its_kmeans(monkeypatch):
    """The port's vectorized first-come packing (balance cap, 2-means
    splits, spills) is the reference's loop: fed the reference's k-means,
    the layouts are equal array for array."""
    db, _, dim = _serving_data(3)
    # a cluster of 150 equal rows: no 2-means split thins it, so it
    # spills to the overflow buffer
    db = np.concatenate([db, np.repeat(db[:1], 150, 0)])
    monkeypatch.setattr(T, "_kmeans", lambda x, k, iters, seed, device=None:
                        J._kmeans(x, k, iters, seed))
    ref = J.ClusteredDeviceIndex(dim, balance_cap=1.05)
    port = ClusteredDeviceIndex(dim, balance_cap=1.05)
    for ix in (ref, port):
        ix.add(db)
        ix.rebuild()
    assert port._overflow == ref._overflow and len(ref._overflow) > 0
    np.testing.assert_array_equal(port._slot_loc, ref._slot_loc)
    for name in ("_centroids", "_pvecs", "_pscales", "_pids", "_ovecs",
                 "_oscales", "_oids"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert port.transfer_bytes == ref.transfer_bytes


def test_port_build_recall_no_worse_than_reference():
    for seed in BUILD_SEEDS:
        db, q, dim = _serving_data(seed)
        k = int(np.sqrt(len(db)))
        jc, ja = J._kmeans(db, k, 8, seed % 17)
        tc, ta = T._kmeans(db, k, 8, seed % 17)
        exact = ExactIndex(dim)
        exact.add(db)
        ref = J.ClusteredDeviceIndex(dim, seed=seed % 17)
        port = ClusteredDeviceIndex(dim, seed=seed % 17)
        for ix in (ref, port):
            ix.add(db)
        r_ref = recall_at_1(ref, exact, q)
        r_port = recall_at_1(port, exact, q)
        print(f"seed {seed}: k-means assigns {(ja == ta).mean():.4f} of "
              f"points alike, max centroid error "
              f"{np.abs(jc - tc).max():.3e}; recall@1 port {r_port:.4f}, "
              f"reference {r_ref:.4f}")
        assert r_port >= r_ref, seed


def test_ivf_recall_reasonable():
    """The reference's IVF case; the port's ids are the reference's where
    the exact runner-up is clear of the best."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(8, 32)) * 5
    db = (centers[rng.integers(0, 8, 600)]
          + rng.normal(size=(600, 32))).astype(np.float32)
    exact = ExactIndex(32)
    exact.add(db)
    ivf, jivf = IVFIndex(32, n_lists=8, nprobe=3), J.IVFIndex(
        32, n_lists=8, nprobe=3)
    for ix in (ivf, jivf):
        ix.add(db)
    q = (centers[rng.integers(0, 8, 50)]
         + rng.normal(size=(50, 32))).astype(np.float32)
    assert recall_at_1(ivf, exact, q) >= 0.9
    (td, ti), (jd, ji) = ivf.search(q, 2), jivf.search(q, 2)
    clear = jd[:, 1] ** 2 - jd[:, 0] ** 2 > MARGIN * jd[:, 1] ** 2
    print(f"ivf: {int((~clear).sum())}/{len(q)} queries within the margin")
    np.testing.assert_array_equal(ti[clear, 0], ji[clear, 0])
    np.testing.assert_allclose(td[:, 0], jd[:, 0], rtol=1e-5)


@pytest.mark.parametrize("index_kind", ["ivf", "exact"])
def test_store_host_ivf_state_matches_reference(index_kind):
    """A reference store with an ivf host index: the port's store loaded
    from its state answers host lookups with the reference's slots."""
    rng = np.random.default_rng(12)
    kw = dict(capacity=4, codec="int8", index_kind=index_kind, n_lists=6)
    j = JaxStore((1, 4, 4), 8, **kw)
    embs = rng.normal(size=(40, 8)).astype(np.float32)
    j.admit(_apm_batch(rng, 40, (1, 4, 4)), embs)
    j.evict(5)
    t = MemoStore((1, 4, 4), 8, **kw)
    t.load_state_dict({k: np.asarray(v) for k, v in j.state_dict().items()})
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v, err_msg=k)
    q = embs[::3] + 0.01
    np.testing.assert_array_equal(t.lookup(q)[1], j.lookup(q)[1])


# ------------------------------------------------------------ copy-on-write
def test_clustered_snapshot_is_immutable_across_sync_and_rebuild():
    """A snapshot's clustered search tuple stays bit-equal across a delta
    sync (packed patch, overflow append, tombstone) and across a rebuild
    that a later sync triggers."""
    apm_shape, dim = (1, 4, 4), 8
    s = MemoStore(apm_shape, dim, capacity=4, cluster_crossover=1)
    rng = np.random.default_rng(13)
    embs = rng.normal(size=(64, dim)).astype(np.float32)
    s.admit(_apm_batch(rng, 64, apm_shape), embs)
    s.sync()
    snap = s.snapshot
    frozen = [a.clone() for a in snap.search_args]
    di = s.device_index
    s.evict(4)
    s.admit(_apm_batch(rng, 6, apm_shape), rng.normal(size=(6, dim)).astype(
        np.float32))
    assert s.sync()["kind"] == "delta" and di.n_rebuilds == 1
    assert len(di._overflow) > 0 and s.snapshot.search_args is not \
        snap.search_args
    for a, b in zip(snap.search_args, frozen):
        assert torch.equal(a, b)
    s.admit(_apm_batch(rng, 40, apm_shape), rng.normal(size=(40, dim)).astype(
        np.float32))
    s.sync()
    assert di.n_rebuilds == 2                    # growth past rebuild_frac
    for a, b in zip(snap.search_args, frozen):
        assert torch.equal(a, b)
    # the old tuple still serves the old generation's answers
    _, idx = di.search_device(torch.from_numpy(embs[10:12]),
                              args=snap.search_args)
    np.testing.assert_array_equal(idx.numpy()[:, 0], [10, 11])
