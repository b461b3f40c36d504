"""The port's codecs, databases, indexes and MemoStore against the JAX
package: the same admit / evict / sync sequence must leave EQUAL host
arrays (``state_dict``), equal slots and equal device-tier contents.
Codec bytes are byte-equal and ``decode_rows`` is bit-equal to the numpy
``decode`` (f16, int8) or within one f16 ulp of it (lowrank, whose factor
product sums in another order); search indices are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core.database import pad_delta_pow2 as jax_pad
from repro.core.index import DeviceIndex as JaxDeviceIndex
from repro.core.index import ExactIndex as JaxExactIndex
from repro.core.store import MemoStore as JaxStore
from repro_torch.core import codec as tcodec
from repro_torch.core.database import AttentionDB, DeviceDB, pad_delta_pow2
from repro_torch.core.index import TOMBSTONE, DeviceIndex, ExactIndex
from repro_torch.core.store import MemoStore
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (2, 8, 8)


def _apms(rng, n, shape=SHAPE):
    x = rng.standard_normal((n,) + shape).astype(np.float32) * 2
    p = np.exp(x - x.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float16)


@pytest.mark.parametrize("name", ["int8", "f16"])
def test_codec_bytes_and_decode_rows_equal(name):
    rng = np.random.default_rng(0)
    a = _apms(rng, 5)
    a[0, 0, 0] = 0.0                       # scale-floor row
    a[1, 1, 2, 3] = 1.0
    jc, tc = jcodec.get_codec(name, SHAPE), tcodec.get_codec(name, SHAPE)
    jp, tp = jc.encode(a), tc.encode(a)
    assert [p.dtype for p in jp] == [p.dtype for p in tp]
    for x, y in zip(jp, tp):
        assert x.tobytes() == y.tobytes()
    host = tc.decode(tp)
    rows = tc.decode_rows(tuple(torch.from_numpy(p) for p in tp))
    assert rows.dtype == torch.float16
    assert rows.numpy().tobytes() == host.tobytes()
    assert np.asarray(jc.decode_rows(tuple(jnp.asarray(p) for p in jp))
                      ).tobytes() == host.tobytes()
    assert tc.entry_nbytes == jc.entry_nbytes


def _f16_ulp(x):
    """One float16 ulp at each value of ``x`` (f16 array)."""
    a = np.abs(x.astype(np.float32))
    return np.spacing(np.maximum(a, 2.0 ** -14).astype(np.float16)
                      ).astype(np.float32)


@pytest.mark.parametrize("rank", [None, 3])
def test_lowrank_codes_equal_and_decode_rows_within_one_ulp(rank):
    """Lowrank codes and scales are the reference's byte for byte (the
    same numpy SVD and quantizer); ``decode_rows`` is within one f16 ulp
    of the numpy ``decode`` and of the reference's jnp ``decode_rows``."""
    rng = np.random.default_rng(0)
    a = _apms(rng, 5)
    a[0, 0] = 0.0                          # a zero head: scale floor
    jc = jcodec.get_codec("lowrank", SHAPE, rank=rank)
    tc = tcodec.get_codec("lowrank", SHAPE, rank=rank)
    assert tc.key == jc.key and tc.entry_nbytes == jc.entry_nbytes
    assert [(p.name, p.shape, p.dtype) for p in tc.parts] == \
        [(p.name, p.shape, p.dtype) for p in jc.parts]
    jp, tp = jc.encode(a), tc.encode(a)
    for x, y in zip(jp, tp):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    host = tc.decode(tp)
    assert host.tobytes() == jc.decode(jp).tobytes()
    rows = tc.decode_rows(tuple(torch.from_numpy(p) for p in tp))
    assert rows.dtype == torch.float16
    jrows = np.asarray(jc.decode_rows(tuple(jnp.asarray(p) for p in jp)))
    for other in (host, jrows):
        gap = np.abs(rows.numpy().astype(np.float32)
                     - other.astype(np.float32))
        assert (gap <= _f16_ulp(other)).all(), gap.max()


def test_lowrank_roundtrip_error_bounded_by_truncation_energy():
    """The reference's bound: ‖APM − decode‖_F per (entry, head) is at
    most the discarded singular mass plus int8 quantization slack."""
    x = np.random.default_rng(2).normal(size=(8, 2, 16, 16))
    e = np.exp(x - x.max(-1, keepdims=True))
    apms = (e / e.sum(-1, keepdims=True)).astype(np.float16)
    c = tcodec.get_codec("lowrank", apms.shape[1:], rank=6)
    dec = c.decode(c.encode(apms)).astype(np.float32)
    x = apms.astype(np.float32)
    _, s, _ = np.linalg.svd(x)
    tail = np.sqrt((s[..., c.rank:] ** 2).sum(-1))
    frob = np.sqrt(((dec - x) ** 2).sum((-1, -2)))
    assert (frob <= tail + 0.35).all(), (frob.max(), tail.max())
    rows = c.decode_rows(tuple(torch.from_numpy(p)
                               for p in c.encode(apms))).float().numpy()
    assert (np.sqrt(((rows - x) ** 2).sum((-1, -2))) <= tail + 0.35).all()


def test_lowrank_waits_and_pad_delta_matches():
    """A lowrank store follows the reference's admit / evict / sync
    sequence (four codec parts on the device), and the padded deltas
    are the reference's."""
    kw = dict(capacity=4, codec="lowrank", device_index_kind="flat")
    t, j = MemoStore(SHAPE, 16, **kw), JaxStore(SHAPE, 16, **kw)
    t.budget_bytes = j.budget_bytes = 7 * j.entry_nbytes
    ta = _run_sequence(t, np.random.default_rng(3))
    ja = _run_sequence(j, np.random.default_rng(3))
    for x, y in zip(ta, ja):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert len(t.snapshot.db_parts) == 4
    for x, y in zip(t.snapshot.db_parts, j.snapshot.db_parts):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v, err_msg=k)
    for n in (1, 3, 4, 5):
        s = np.arange(n) * 3
        v = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        a, b = pad_delta_pow2(s, v), jax_pad(s, v)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_attention_db_recycles_like_reference():
    from repro.core.database import AttentionDB as JaxDB
    rng = np.random.default_rng(1)
    t, j = AttentionDB(SHAPE, capacity=2, codec="int8"), JaxDB(
        SHAPE, capacity=2, codec="int8")
    a = _apms(rng, 5)
    np.testing.assert_array_equal(t.put(a), j.put(a))
    t.release([1, 3])
    j.release([1, 3])
    b = _apms(rng, 3)
    np.testing.assert_array_equal(t.put(b), j.put(b))
    assert t._free == j._free and t.capacity == j.capacity
    for x, y in zip(t._arenas, j._arenas):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(t.checksums, j.checksums):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t.get([0, 4]), j.get([0, 4]))
    dd = DeviceDB.from_host(t, capacity=9)
    assert dd.capacity == 9 and len(dd) == t._n
    np.testing.assert_array_equal(dd.gather(torch.tensor([0, 4])).numpy(),
                                  t.get([0, 4], count_reuse=False))


def test_indexes_match_reference():
    rng = np.random.default_rng(2)
    embs = rng.standard_normal((20, 16)).astype(np.float32)
    q = embs[[3, 7, 0]] + 0.01 * rng.standard_normal((3, 16)).astype(
        np.float32)
    te, je = ExactIndex(16), JaxExactIndex(16)
    for ix in (te, je):
        ix.assign(np.arange(20), embs)
        ix.remove([7])
    (td, ti), (jd, ji) = te.search(q, 1), je.search(q, 1)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(te.search(q, 3)[1], je.search(q, 3)[1])
    td_, jd_ = DeviceIndex(16, capacity=4), JaxDeviceIndex(16, capacity=4)
    for ix in (td_, jd_):
        ix.add(embs[:10])
        ix.assign([12, 3], embs[[12, 13]])
        ix.remove([5])
    np.testing.assert_array_equal(td_.table.numpy(), np.asarray(jd_.table))
    assert td_.transfer_bytes == jd_.transfer_bytes
    for fused in (False, True):
        (d2, i), (jd2, ji2) = (td_.search_device(torch.from_numpy(q),
                                                 fused=fused),
                               jd_.search_device(jnp.asarray(q)))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji2))
        # the matmul form cancels: absolute error ~ eps·‖q‖²
        np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-4,
                                   atol=1e-5)
    assert td_.table[20:].eq(TOMBSTONE).all()


def _run_sequence(store, rng):
    """One admit/evict/sync sequence; returns what each step handed back."""
    out = []
    out.append(store.admit(_apms(rng, 6), rng.standard_normal(
        (6, 16)).astype(np.float32)))
    out.append(store.sync()["kind"])
    store.note_reuse(out[0][:3])
    out.append(store.admit(_apms(rng, 3), rng.standard_normal(
        (3, 16)).astype(np.float32)))               # over budget: CLOCK
    out.append(store.evict(2))
    out.append(store.sync()["kind"])
    out.append(store.admit(_apms(rng, 2), rng.standard_normal(
        (2, 16)).astype(np.float32), lengths=[5, 8]))
    out.append(store.sync()["kind"])
    out.append(store.sync()["kind"])                # clean: noop
    return out


@pytest.mark.parametrize("codec", ["int8", "f16"])
def test_store_sequence_matches_reference(codec):
    kw = dict(capacity=4, codec=codec, device_index_kind="flat")
    t = MemoStore(SHAPE, 16, **kw)
    j = JaxStore(SHAPE, 16, **kw)
    t.budget_bytes = j.budget_bytes = 7 * j.entry_nbytes
    ta = _run_sequence(t, np.random.default_rng(3))
    ja = _run_sequence(j, np.random.default_rng(3))
    for x, y in zip(ta, ja):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert ta[1] == "full" and ta[4] == "delta" and ta[7] == "noop"
    ts, js = t.state_dict(), j.state_dict()
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    for f in ("n_admitted", "n_evicted", "n_noop_syncs", "n_delta_syncs",
              "n_full_syncs", "bytes_delta", "bytes_full"):
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    for x, y in zip(t.snapshot.db_parts, j.snapshot.db_parts):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(t.snapshot.lengths.numpy(),
                                  np.asarray(j.snapshot.lengths))
    np.testing.assert_array_equal(t.snapshot.search_args[0].numpy(),
                                  np.asarray(j.snapshot.search_args[0]))
    q = t.embeddings_at([0, 2, 4]) + 0.01
    np.testing.assert_array_equal(t.lookup(q)[1], j.lookup(q)[1])


def test_store_load_state_dict_from_reference():
    """The bridge's store path: a reference state_dict served by the port
    (host arrays equal, device tier materialized by a full sync)."""
    j = JaxStore(SHAPE, 16, capacity=4, codec="int8")
    rng = np.random.default_rng(4)
    j.admit(_apms(rng, 9), rng.standard_normal((9, 16)).astype(np.float32))
    j.evict(2)
    j.sim_cal = (-0.5, 0.9)
    t = MemoStore(SHAPE, 16, capacity=9, codec="int8")
    t.load_state_dict({k: np.asarray(v) for k, v in j.state_dict().items()})
    for k, v in j.state_dict().items():
        np.testing.assert_array_equal(t.state_dict()[k], v, err_msg=k)
    assert t.sync()["kind"] == "full" and t.snapshot.sim_a == -0.5
    assert t.verify_integrity() == []


def test_store_refuses_what_waits(tmp_path):
    # the capacity tier is ported: a directory that cannot be made
    # detaches the tier (RAM-only serving) instead of raising
    blocker = tmp_path / "file"
    blocker.write_text("")
    s = MemoStore(SHAPE, 16, capacity_dir=str(blocker / "tier"))
    assert not s.capacity_ok and s.capacity is None
    assert "Error" in s.capacity_error and s.stats.n_disk_errors == 1
    # the clustered device index and the ivf host index serve: the
    # crossover store syncs onto a built clustered index, and the ivf
    # store's host lookup finds its entries
    s = MemoStore(SHAPE, 16, capacity=4, cluster_crossover=4)
    rng = np.random.default_rng(5)
    embs = rng.standard_normal((4, 16)).astype(np.float32)
    s.admit(_apms(rng, 4), embs)
    assert s.sync()["kind"] == "full"
    assert type(s.device_index).__name__ == "ClusteredDeviceIndex"
    _, idx = s.device_index.search(embs)
    np.testing.assert_array_equal(idx[:, 0], np.arange(4))
    s = MemoStore(SHAPE, 16, index_kind="ivf", n_lists=2)
    s.admit(_apms(rng, 4), embs)
    assert type(s.index).__name__ == "IVFIndex" and s.index.n_lists == 2
    np.testing.assert_array_equal(s.lookup(embs)[1][:, 0], np.arange(4))


def test_store_fault_points():
    """The copied fault registry threads through the port's store: an
    injected sync failure raises before any mutation, a corrupted
    admission is quarantined at the next sync, and a bogus eviction
    policy output is refused."""
    from repro_torch.core.faults import FaultInjector, MemoStoreError
    rng = np.random.default_rng(6)
    inj = FaultInjector.from_spec({})
    s = MemoStore(SHAPE, 16, capacity=4, codec="int8", faults=inj)
    s.admit(_apms(rng, 4), rng.standard_normal((4, 16)).astype(np.float32))
    inj.arm("store.sync_fail", count=1)
    gen = s.generation
    with pytest.raises(MemoStoreError):
        s.sync()
    assert s.device_db is None and s.generation == gen
    assert s.sync()["kind"] == "full"
    inj.arm("store.corrupt_row", count=1)
    slot = s.admit(_apms(rng, 1), rng.standard_normal((1, 16)).astype(
        np.float32))
    s.sync()
    assert s.stats.n_quarantined == 1 and not s.db._live[int(slot[0])]
    assert int(s.snapshot.lengths[int(slot[0])]) == -1
    inj.arm("store.evict_bogus", count=1)
    assert len(s.evict(1)) == 1 and s.stats.n_evict_rejected >= 2
