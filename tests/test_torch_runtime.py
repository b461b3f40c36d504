"""The port's MemoServer runtime and variable-length serving against the
JAX reference (the counterpart of ``tests/test_runtime.py``).

One reference engine is built once, as ``tests/test_runtime.py`` builds
it (reduced bert_base: 2 layers, d 128, 4 heads, seq 32, bucket mode,
device slack 8), and every case serves a port engine freshly bridged
from it (``repro_torch/bridge.py``), so no case sees another's
admissions. The cases of the reference file keep their names; the
reference's bounded jit-shape count becomes a bound on the (bucket,
padded rows) shapes served, since eager PyTorch compiles nothing.

Beyond them:
* ``test_snapshot_is_immutable_across_delta_sync`` — after admit, evict
  and a delta sync, the superseded snapshot's tensors are byte-equal to
  clones taken before (copy-on-write: ``core/store.py``);
* ``test_sync_maintenance_matches_reference_server`` — the JAX
  ``MemoServer`` and the port's serve the same request trace with
  synchronous maintenance and admission on: per batch the bucket, row
  count, valid rows, per-layer hit masks and matched slots and the
  admitted slot ids are EQUAL, logits within 1e-4
  (``tests/test_torch_admission.py``'s tolerance). The threshold's margin
  to every predicted sim is asserted ≥ 1e-3, so an ulp of search
  arithmetic cannot flip a decision.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.engine as engine_mod
from repro_torch.bridge import engine_from_reference
from repro_torch.configs import get_reduced
from repro_torch.core.engine import MemoStats, SimReservoir
from repro_torch.core.runtime import MemoServer, pow2_buckets
from repro_torch.core.store import StoreSnapshot
from repro_torch.launch.server import make_workload
from repro_torch.models import backbone as bb
from repro_torch.models import build_model
from repro_torch.models.layers import norm_apply
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 32
LOGIT_ATOL = 1e-4
MARGIN = 1e-3
REDUCED = dict(n_classes=4, n_layers=2, d_model=128, d_ff=256, n_heads=4)


@pytest.fixture(scope="module")
def ref():
    from repro.configs import get_reduced as jax_reduced
    from repro.core.engine import MemoEngine
    from repro.data import TemplateCorpus
    from repro.memo import MemoSpec
    from repro.models import build_model as jax_build_model

    jcfg = jax_reduced("bert_base").replace(**REDUCED)
    m = jax_build_model(jcfg, layer_loop="unroll")
    corpus = TemplateCorpus(vocab=jcfg.vocab, seq_len=SEQ, n_templates=6,
                            slot_fraction=0.2)
    jeng = MemoEngine(m, m.init(jax.random.PRNGKey(0)),
                      MemoSpec.flat(threshold=0.6, embed_steps=40,
                                    mode="bucket", device_slack=8.0))
    jeng.build(jax.random.PRNGKey(1),
               [{"tokens": jnp.asarray(corpus.sample(16)[0])}
                for _ in range(3)])
    return jeng, corpus, get_reduced("bert_base").replace(**REDUCED)


@pytest.fixture
def vl(ref):
    """A port engine freshly bridged from the reference."""
    jeng, corpus, cfg = ref
    return engine_from_reference(jeng, build_model(cfg, device="cpu"),
                                 device="cpu"), corpus


def _varlen_batch(corpus, lens, pad_to):
    toks = np.asarray(corpus.sample(len(lens))[0][:, :pad_to])
    lens = np.asarray(lens, np.int32)
    for i, ln in enumerate(lens):
        toks[i, ln:] = 0
    return toks, lens


def _layer0_input(eng, toks):
    lp0 = eng._iter_layers()[0][2]
    h = bb.embed_tokens(eng.params, torch.from_numpy(toks), eng.cfg)
    return norm_apply(lp0["norm1"], h, eng.cfg.norm)


# ------------------------------------------- mask-aware padding parity

def test_masked_embedding_parity_padded_vs_unpadded(ref, vl):
    """The same sequence embeds identically whether it arrives padded to
    a bucket or at its exact length, and as the reference embeds it."""
    eng, corpus = vl
    lens = [SEQ, SEQ // 2, SEQ - 8, SEQ // 2]
    toks, lens_np = _varlen_batch(corpus, lens, SEQ)
    e_pad = eng._embed(_layer0_input(eng, toks),
                       lengths=torch.from_numpy(lens_np)).numpy()
    jeng = ref[0]
    np.testing.assert_allclose(
        e_pad, np.asarray(jeng._embed(_layer0_input_jax(jeng, toks),
                                      lengths=lens_np)), atol=1e-5)
    for i, ln in enumerate(lens):
        e_i = eng._embed(_layer0_input(eng, toks[i:i + 1, :ln]),
                         lengths=torch.tensor([ln])).numpy()
        np.testing.assert_allclose(e_pad[i], e_i[0], rtol=1e-5, atol=1e-5)


def _layer0_input_jax(jeng, toks):
    from repro.models import backbone as jbb
    lp0 = jeng._iter_layers()[0][2]
    h = jbb.embed_tokens(jeng.params, jnp.asarray(toks), jeng.cfg)
    return jbb.norm_apply(lp0["norm1"], h, jeng.cfg.norm)


def _serve_prep(eng, batch, thr):
    prep = eng.prepare_batch(batch, threshold=thr)
    eng.run_layers(prep)
    hits = torch.stack([p[2] for p in prep.pend]).numpy()     # (L, B)
    out, _, _ = eng.finalize(prep)
    return out.numpy(), hits


def test_padded_batch_matches_unpadded_per_length_run(vl):
    """A padded variable-length batch gives the same per-sequence hit
    decisions and logits as running each length group unpadded at its
    own sequence length."""
    eng, corpus = vl
    lens = [SEQ, SEQ, SEQ // 2, SEQ // 2]
    toks, lens_np = _varlen_batch(corpus, lens, SEQ)
    out_pad, hits_pad = _serve_prep(
        eng, {"tokens": toks, "lengths": lens_np}, 0.6)
    for ln in sorted(set(lens)):
        rows = [i for i, x in enumerate(lens) if x == ln]
        out_u, hits_u = _serve_prep(
            eng, {"tokens": toks[rows][:, :ln],
                  "lengths": np.full(len(rows), ln, np.int32)}, 0.6)
        np.testing.assert_array_equal(hits_pad[:, rows], hits_u)
        np.testing.assert_allclose(out_pad[rows], out_u, rtol=2e-3,
                                   atol=2e-3)


def test_varlen_fast_path_matches_select(vl):
    """Fast-path logits == select reference on the same padded batch, and
    the length gate forces misses for lengths with no same-length entry
    (the calibration corpus is all full-length)."""
    eng, corpus = vl
    toks, lens_np = _varlen_batch(corpus, [SEQ, SEQ - 4, SEQ // 2, SEQ], SEQ)
    batch = {"tokens": toks, "lengths": lens_np}
    out_fast, st = eng.infer(batch, threshold=-1e9)
    eng.mc.mode = "select"
    out_sel, st_sel = eng.infer(batch, threshold=-1e9)
    np.testing.assert_allclose(out_fast.numpy(), out_sel.numpy(),
                               rtol=2e-3, atol=2e-3)
    n_layers = len(eng.layers)
    assert st.n_hits == 2 * n_layers
    assert st_sel.n_hits == 2 * n_layers


def test_varlen_admission_learns_new_lengths(vl):
    """Captured misses are admitted at their true length and hit on the
    next same-length batch (the store adapts per length)."""
    eng, corpus = vl
    eng.mc.admit = True
    toks, lens_np = _varlen_batch(corpus, [SEQ - 8] * 4, SEQ)
    batch = {"tokens": toks, "lengths": lens_np}
    _, st1 = eng.infer(batch, threshold=0.6)
    assert st1.n_admitted > 0
    lens_stored = eng.store.entry_lengths(np.arange(len(eng.db)))
    assert (lens_stored == SEQ - 8).sum() == st1.n_admitted
    _, st2 = eng.infer(batch, threshold=0.6)
    assert st2.n_hits == len(eng.layers) * 4      # exact replay hits


# ------------------------------------------------- runtime invariants

def test_runtime_zero_per_layer_host_sync(vl, monkeypatch):
    """One batch through MemoServer.step makes exactly ONE synchronize
    (``finalize``'s barrier), no host transfer inside ``run_layers``, and
    at most three device→host reads: the two stacked stats blocks and
    the logits."""
    eng, corpus = vl
    server = MemoServer(eng, buckets=(SEQ // 2, SEQ), max_batch=4,
                        batch_quantum=4, async_maintenance=False)
    server.warmup(batch_sizes=[4])

    def submit_four():
        for ln in (SEQ, SEQ - 2, SEQ, SEQ):
            server.submit(np.asarray(corpus.sample(1)[0][0, :ln]))
    submit_four()
    server.step(flush=True)           # drain a first batch post-warmup
    assert server.queued == 0
    submit_four()                     # the counted batch
    calls, in_layers = [], []
    for name in ("item", "cpu", "numpy", "tolist"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _n=name, _r=real, **k:
            calls.append((_n, bool(in_layers))) or _r(self, *a, **k))
    real_sync = engine_mod.synchronize
    monkeypatch.setattr(engine_mod, "synchronize", lambda *a: calls.append(
        ("synchronize", bool(in_layers))) or real_sync(*a))
    real_run = eng.run_layers

    def run_layers(prep):
        in_layers.append(1)
        try:
            return real_run(prep)
        finally:
            in_layers.pop()
    eng.run_layers = run_layers
    comps = server.step(flush=True)
    assert len(comps) == 4
    assert not [c for c in calls if c[1]], calls
    names = [c[0] for c in calls]
    assert names.count("synchronize") == 1
    assert names.count("cpu") <= 3 and "item" not in names
    server.close()


def test_runtime_bounded_jit_shape_set(vl):
    """Arbitrary request lengths serve at most len(buckets) x
    log2(max_batch) (bucket, padded rows) shapes — the reference's bound
    on its compiled shapes, here on the kernels' and allocator's."""
    eng, corpus = vl
    server = MemoServer(eng, buckets=(SEQ // 2, SEQ), max_batch=4,
                        batch_quantum=2, async_maintenance=False)
    shapes = set()
    real = eng.prepare_batch

    def prepare_batch(batch, **kw):
        shapes.add(tuple(batch["tokens"].shape[::-1]))
        return real(batch, **kw)
    eng.prepare_batch = prepare_batch
    rng = np.random.default_rng(3)
    for _ in range(6):
        for __ in range(int(rng.integers(1, 5))):
            ln = int(rng.integers(4, SEQ + 1))
            server.submit(np.asarray(corpus.sample(1)[0][0, :ln]))
        server.step(flush=True)
    # buckets {16, 32} x row paddings {2, 4} = 4 shapes max
    assert shapes <= {(b, r) for b in (SEQ // 2, SEQ) for r in (2, 4)}
    assert len(shapes) <= len(server.buckets) * int(np.log2(4))
    server.close()


def test_runtime_async_matches_sync_serving(vl):
    """With maintenance idle (no admission), async and sync runtimes are
    the same serving machine: identical logits for identical requests."""
    eng, corpus = vl
    reqs = [np.asarray(corpus.sample(1)[0][0, :ln])
            for ln in (SEQ, SEQ - 4, SEQ // 2, SEQ)]
    outs = {}
    for mode in (False, True):
        server = MemoServer(eng, buckets=(SEQ // 2, SEQ), max_batch=4,
                            async_maintenance=mode)
        with server:
            for r in reqs:
                server.submit(r)
            comps = []
            while server.queued:
                comps.extend(server.step(flush=True))
        outs[mode] = {c.rid: c.logits for c in comps}
    assert outs[False].keys() == outs[True].keys()
    for rid in outs[False]:
        np.testing.assert_allclose(outs[False][rid], outs[True][rid],
                                   rtol=1e-5, atol=1e-5)


def test_runtime_async_maintenance_applies_and_publishes(vl):
    """Async mode: admissions queued by finalize are applied off-thread;
    after drain the snapshot generation advanced and a repeat batch hits
    on the admitted entries."""
    eng, corpus = vl
    eng.mc.admit = True
    gen0 = eng.store.snapshot.generation
    n0 = eng.store.stats.n_admitted
    server = MemoServer(eng, buckets=(SEQ // 2, SEQ), max_batch=4,
                        async_maintenance=True)
    toks = [np.asarray(corpus.sample(1)[0][0, :SEQ - 12])
            for _ in range(4)]
    with server:
        for t in toks:
            server.submit(t)
        server.step(flush=True)
        server.drain_maintenance()
        snap = eng.store.snapshot
        assert isinstance(snap, StoreSnapshot)
        assert snap.generation > gen0
        assert eng.store.stats.n_admitted > n0
        for t in toks:                      # same requests again
            server.submit(t)
        comps = server.step(flush=True)
    assert len(comps) == 4
    assert server.stats.n_hits >= len(eng.layers) * 4   # second pass hits
    assert not server.maintenance_errors


def test_fixed_length_queries_never_replay_shorter_entries(vl):
    """The length gate is ALWAYS on: a fixed-length batch (no lengths)
    must not hit an entry admitted at a shorter true length."""
    eng, corpus = vl
    store = eng.store
    toks = np.asarray(corpus.sample(4)[0])
    embs = eng._embed(_layer0_input(eng, toks)).numpy()
    apms = np.zeros((4,) + store.apm_shape, np.float16)
    store.admit(apms, embs, lengths=np.full(4, 10, np.int32))
    store.sync()
    out, st = eng.infer({"tokens": toks}, threshold=-1e9)
    # layer 0's top-1 is the distance-0 poisoned entry — without the
    # gate all 4 rows would hit it; with it they are length-gated misses
    assert st.per_layer_hits.get(eng.layers[0], 0) == 0
    assert torch.isfinite(out).all()


# ------------------------------------------------- thread-safe stats

def test_sim_reservoir_concurrent_append_is_lossless():
    res = SimReservoir(cap=128)
    n_threads, per = 8, 500

    def work(seed):
        for i in range(per):
            res.append(float(seed * per + i))

    ts = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert res.seen == n_threads * per
    assert len(res) == 128


def test_memostats_concurrent_merge():
    total = MemoStats()
    n_threads, per = 6, 50

    def work():
        for _ in range(per):
            st = MemoStats(n_layer_attempts=4, n_hits=2,
                           per_layer_hits={0: 1, 1: 1})
            st.sims.extend([0.5, 0.6])
            total.merge(st)
            total.add_admitted(1)

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    n = n_threads * per
    assert total.n_layer_attempts == 4 * n
    assert total.n_hits == 2 * n
    assert total.n_admitted == n
    assert total.per_layer_hits == {0: n, 1: n}
    assert total.sims.seen == 2 * n


# ----------------------------------------------- snapshot publication

def _random_entries(store, n, seed):
    rng = np.random.default_rng(seed)
    apms = rng.random((n,) + store.apm_shape).astype(np.float16)
    embs = rng.normal(size=(n, store.embed_dim)).astype(np.float32)
    return apms, embs


def test_snapshot_is_stable_until_next_sync(vl):
    """Host-tier mutation does not change the published snapshot until
    the next sync commits a new generation."""
    eng, _ = vl
    store = eng.store
    store.sync()
    snap = store.snapshot
    apms, embs = _random_entries(store, 2, 5)
    store.admit(apms, embs, lengths=np.asarray([7, 9], np.int32))
    assert store.snapshot is snap                 # not yet published
    assert store.device_stale
    store.sync()
    snap2 = store.snapshot
    assert snap2 is not snap
    assert snap2.generation > snap.generation
    # the superseded snapshot's arrays are still alive and consistent
    assert snap.db_parts[0].shape == snap2.db_parts[0].shape


def test_snapshot_is_immutable_across_delta_sync(vl):
    """A delta sync (admission into fresh and recycled slots, an
    eviction's tombstone) never writes into a published snapshot: the
    old snapshot's arena parts, index table, row norms and lengths stay
    byte-equal to clones taken before it, while the new snapshot holds
    the admitted rows."""
    eng, _ = vl
    store = eng.store
    store.sync()
    old = store.snapshot
    before = [t.clone() for t in (*old.db_parts, *old.search_args,
                                  old.lengths)]
    store.evict(3)
    apms, embs = _random_entries(store, 5, 7)
    slots = store.admit(apms, embs, lengths=np.full(5, 11, np.int32))
    deltas, fulls = store.stats.n_delta_syncs, store.stats.n_full_syncs
    assert store.sync()["kind"] == "delta"
    assert (store.stats.n_delta_syncs, store.stats.n_full_syncs) == (
        deltas + 1, fulls)
    after = (*old.db_parts, *old.search_args, old.lengths)
    for i, (b, a) in enumerate(zip(before, after)):
        assert torch.equal(b, a), f"snapshot tensor {i} changed"
    new = store.snapshot
    sl = torch.from_numpy(slots)
    for part, host in zip(new.db_parts, store.db.parts_at(slots)):
        np.testing.assert_array_equal(part.index_select(0, sl).numpy(),
                                      host)
    np.testing.assert_array_equal(
        new.search_args[0].index_select(0, sl).numpy(), embs)
    assert (new.lengths.index_select(0, sl) == 11).all()


def test_pow2_buckets():
    assert pow2_buckets(64) == (16, 32, 64)
    assert pow2_buckets(32, n=2) == (16, 32)
    assert pow2_buckets(8) == (8,)


# ------------------------------------- sync maintenance vs the reference

def _recorder(eng, pend_of, to_np):
    """Wrap ``prepare_batch``/``run_layers`` and the store's ``admit`` of
    one engine: per batch its (bucket, rows, n_valid), the per-layer
    (sims, hits, slots) and the admitted slot ids."""
    log = {"shape": [], "layers": [], "admit": []}
    prepare, run, admit = eng.prepare_batch, eng.run_layers, eng.store.admit

    def prepare_batch(batch, **kw):
        rows, bucket = np.asarray(batch["tokens"]).shape
        log["shape"].append((bucket, rows, int(batch["n_valid"])))
        return prepare(batch, **kw)

    def run_layers(prep):
        out = run(prep)
        log["layers"].append([tuple(to_np(x) for x in p[1:4])
                              for p in pend_of(prep)])
        return out

    def rec_admit(*a, **k):
        slots = admit(*a, **k)
        log["admit"].append(np.asarray(slots).tolist())
        return slots
    eng.prepare_batch, eng.run_layers = prepare_batch, run_layers
    eng.store.admit = rec_admit
    return log


def test_sync_maintenance_matches_reference_server(ref):
    """The same request trace (two drift phases, three length buckets'
    worth of lengths) through the JAX MemoServer and the port's with
    synchronous maintenance, admission (a budget 8 entries above the
    built store, so it evicts) and recalibration every second flush."""
    from repro.core.runtime import MemoServer as JaxServer
    from repro.data import TemplateCorpus
    jeng, corpus, cfg = ref
    saved = (jeng.store, jeng.mc.admit, jeng.mc.budget_mb,
             jeng.mc.recal_every)
    state = jeng.store.state_dict()
    try:
        nbytes = jeng.store.entry_nbytes
        jeng.mc.admit, jeng.mc.recal_every = True, 2
        jeng.mc.budget_mb = (len(jeng.store) + 8.5) * nbytes / 1e6
        jeng.store = jeng._make_store(tuple(saved[0].apm_shape),
                                      capacity=len(saved[0]))
        jeng.store.load_state_dict(state)
        jeng._serve_batches, jeng._flush_count = 0, 0
        jeng._pending_admissions, jeng._recal_buf = [], []
        teng = engine_from_reference(jeng, build_model(cfg, device="cpu"),
                                     device="cpu")
        jlog = _recorder(jeng, lambda p: p.pend, np.asarray)
        tlog = _recorder(teng, lambda p: p.pend, lambda x: x.numpy())
        drift = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, seed=117,
                               n_templates=6, slot_fraction=0.2)
        trace = make_workload([corpus, drift], 24, 1.0, (8, 16, SEQ),
                              seed=7)
        comps = {}
        for name, eng, Server in (("jax", jeng, JaxServer),
                                  ("torch", teng, MemoServer)):
            server = Server(eng, buckets=(8, 16, SEQ), max_batch=4,
                            batch_quantum=2, async_maintenance=False)
            got = []
            with server:
                for i in range(0, len(trace), 6):  # 6 arrivals, then drain
                    for _, toks in trace[i: i + 6]:
                        server.submit(toks)
                    while server.queued:
                        got.extend(server.step(flush=True))
            comps[name] = {c.rid: np.asarray(c.logits) for c in got}
        jcal = jeng.sim_cal
    finally:
        jeng.store, jeng.mc.admit, jeng.mc.budget_mb, \
            jeng.mc.recal_every = saved
        del jeng.prepare_batch, jeng.run_layers
    assert jlog["shape"] == tlog["shape"] and len(jlog["shape"]) >= 8
    assert {b for b, _, _ in tlog["shape"]} == {8, 16, SEQ}
    thr = jeng.mc.threshold
    for b, (jl, tl) in enumerate(zip(jlog["layers"], tlog["layers"])):
        for li, ((js, jh, ji), (ts, th, ti)) in enumerate(zip(jl, tl)):
            assert np.abs(js - thr).min() >= MARGIN, (b, li)
            np.testing.assert_array_equal(th, jh, err_msg=f"hits {b} {li}")
            np.testing.assert_array_equal(ti, ji, err_msg=f"slots {b} {li}")
    assert tlog["admit"] == jlog["admit"] and len(tlog["admit"]) >= 8
    assert teng.store.stats.n_evicted > 0
    assert sorted(comps["torch"]) == sorted(comps["jax"]) == list(range(24))
    for rid, logits in comps["jax"].items():
        np.testing.assert_allclose(comps["torch"][rid], logits, rtol=0,
                                   atol=LOGIT_ATOL)
    np.testing.assert_allclose(teng.sim_cal, jcal, atol=1e-4)
