"""Online admission and recalibration in the port against the JAX engine.

The reduced bert_base reference of ``tests/test_torch_engine.py`` (its
``built`` fixture, built once for this module) seeds every case: its
calibration entries are admitted into a fresh store of the case's codec
whose byte budget holds 8 entries more than that, so the first flush
evicts; the port gets the same state through the bridge. Both packages
then serve three batches (the second query batch, then the first twice:
the replay may hit just-admitted entries) with ``admit=True``,
``recal_every=1`` and ``admit_every`` 1 or 2, on the fast path (kernel
mode) and on the host path (select mode). After each batch:

* per-layer hits and slots EQUAL, logits within 1e-4, and the squared
  search distances behind the sims within 1e-5 of the largest squared
  embedding norm: a replayed row's nearest entry is its own capture, so
  its d² is ~0 in exact arithmetic and f32 cancellation in the
  matmul-form d² (|q|² + |d|² − 2q·d) is all that is left; the sqrt in
  sim = a·√d² + b magnifies that noise (1.1e-4 in sim measured), so
  sims are compared where they are well conditioned, as d² (largest gap
  measured on this CPU 2.7e-6, against an atol of 1.7e-5);
* admitted and evicted slot ids, ``live_mask``, entry lengths,
  ``n_admitted`` and ``_serve_batches`` EQUAL;
* admitted embeddings within 1e-5;
* admitted APM bytes: f16 within 1 f16 ulp, int8 codes within one step
  and their f16 row scales within 1 f16 ulp (the true APMs come from two
  f32 attention implementations and may round apart);
* ``sim_cal`` within 1e-4 (largest gap measured on this CPU: 7.3e-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import engine_from_reference
from test_torch_engine import MARGIN, _mid_threshold, built  # noqa: F401
from test_torch_select import _serve_host
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCHES = (1, 0, 0)                   # query batches served, in order
SIM_CAL_ATOL = 1e-4


@pytest.fixture(scope="module")
def seed(built):
    """The reference's calibration entries (decoded f16 APMs, embeddings,
    lengths), its ``sim_cal``, and a mid threshold of the first served
    batch found before any case mutates a store."""
    jeng = built[0]
    st = jeng.store
    slots = np.arange(len(st))
    entries = (st.db.get(slots, count_reuse=False), st.embeddings_at(slots),
               st.entry_lengths(slots))
    jeng.mc.mode = "kernel"
    thr = _mid_threshold(jeng, {"tokens": jnp.asarray(built[2][BATCHES[0]])})
    return entries, tuple(jeng.sim_cal), thr


def _fresh(jeng, model, seed, *, mode, codec, every):
    """A fresh reference store of ``codec`` holding the seed entries under
    a budget of 8 more, the engine's admission counters reset, and the
    port engine bridged from it."""
    (apms, embs, lens), cal, _ = seed
    mc = jeng.mc
    mc.mode, mc.apm_codec, mc.device_index = mode, codec, "flat"
    mc.admit, mc.admit_every, mc.recal_every = True, every, 1
    mc.budget_mb = None
    nbytes = jeng._make_store(apms.shape[1:], capacity=1).entry_nbytes
    mc.budget_mb = (len(apms) + 8.5) * nbytes / 1e6
    jeng.store = jeng._make_store(apms.shape[1:], capacity=len(apms))
    jeng.store.admit(apms, embs, lens)
    jeng.sim_cal = cal
    jeng._serve_batches, jeng._flush_count = 0, 0
    jeng._pending_admissions, jeng._recal_buf = [], []
    teng = engine_from_reference(jeng, model, device="cpu")
    return teng, _record(jeng.store), _record(teng.store)


def _record(store):
    """Log the slots every ``admit`` assigns and every ``evict`` frees
    (the store's own eviction inside ``admit`` included)."""
    log = {"admit": [], "evict": []}
    admit, evict = store.admit, store.evict

    def rec_admit(*a, **k):
        slots = admit(*a, **k)
        log["admit"].append(np.asarray(slots).tolist())
        return slots

    def rec_evict(*a, **k):
        out = evict(*a, **k)
        log["evict"].append([int(s) for s in out])
        return out
    store.admit, store.evict = rec_admit, rec_evict
    return log


def _serve_fast(eng, batch, thr):
    """``infer``'s fast-path steps; returns the logits, the per-layer
    (li, sims, hits, slots) as numpy and the stats."""
    prep = eng.prepare_batch(batch, threshold=thr)
    eng.run_layers(prep)
    pend = [(li, np.asarray(s), np.asarray(h), np.asarray(i))
            for li, s, h, i, *_ in prep.pend]
    out, st, payload = eng.finalize(prep)
    eng.apply_maintenance(payload, stats=st)
    return np.asarray(out), pend, st


def _same_decisions(jl, jp, jcal, tl, tp, tcal, d2_atol):
    """Equal hits and slots per layer, logits within 1e-4, and each
    side's sims turned back into d² by its own calibration within
    ``d2_atol``."""
    assert [p[0] for p in tp] == [p[0] for p in jp] == [0, 1]
    for (li, js, jh, ji), (_, ts, th, ti) in zip(jp, tp):
        np.testing.assert_array_equal(th, jh, err_msg=f"hits layer {li}")
        np.testing.assert_array_equal(ti, ji, err_msg=f"slots layer {li}")
        d2 = [((s - b) / a) ** 2 for s, (a, b) in ((js, jcal), (ts, tcal))]
        np.testing.assert_allclose(d2[1], d2[0], rtol=0, atol=d2_atol,
                                   err_msg=f"d2 layer {li}")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)


def _within_ulp(a, b):
    a, b = a.astype(np.float16), b.astype(np.float16)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return bool((np.abs(a.astype(np.float32) - b.astype(np.float32))
                 <= ulp.astype(np.float32)).all())


def _same_store(js, ts, admitted, codec):
    np.testing.assert_array_equal(ts.db.live_mask, js.db.live_mask)
    n = len(js)
    assert len(ts) == n
    np.testing.assert_array_equal(ts.entry_lengths(np.arange(n)),
                                  js.entry_lengths(np.arange(n)))
    if not admitted:
        return
    np.testing.assert_allclose(ts.embeddings_at(admitted),
                               js.embeddings_at(admitted), atol=1e-5)
    tp, jp = ts.db.parts_at(admitted), js.db.parts_at(admitted)
    if codec == "f16":
        assert _within_ulp(tp[0], jp[0]), "f16 APM rows beyond 1 ulp"
    else:
        steps = np.abs(tp[0].astype(np.int32) - jp[0].astype(np.int32))
        assert steps.max() <= 1, f"int8 codes {steps.max()} steps apart"
        assert _within_ulp(tp[1], jp[1]), "int8 row scales beyond 1 ulp"


@pytest.mark.parametrize("codec", ["int8", "f16"])
@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("path", ["fast", "host"])
def test_admission_matches_reference(built, seed, path, every, codec):
    jeng, teng0, queries = built
    thr = seed[2]
    teng, jlog, tlog = _fresh(jeng, teng0.model, seed, codec=codec,
                              every=every,
                              mode="kernel" if path == "fast" else "select")
    serve = _serve_fast if path == "fast" else _serve_host
    d2_atol = 1e-5 * float(np.max(np.sum(seed[0][1] ** 2, -1)))
    n_admitted = 0
    for t, qi in enumerate(BATCHES):
        q = queries[qi]
        jcal, tcal = jeng.sim_cal, teng.sim_cal
        jl, jp, jst = serve(jeng, {"tokens": jnp.asarray(q)}, thr)
        tl, tp, tst = serve(teng, {"tokens": q}, thr)
        sims = np.concatenate([p[1] for p in jp])
        assert np.abs(sims - thr).min() >= MARGIN / 10, \
            f"batch {t}: a reference sim within {MARGIN / 10} of thr"
        _same_decisions(jl, jp, jcal, tl, tp, tcal, d2_atol)
        assert tlog == jlog, f"batch {t}: admit/evict logs differ"
        assert tst.n_admitted == jst.n_admitted
        assert teng._serve_batches == jeng._serve_batches == t + 1
        admitted = tlog["admit"][-1] if tst.n_admitted else []
        _same_store(jeng.store, teng.store, admitted, codec)
        np.testing.assert_allclose(teng.sim_cal, jeng.sim_cal,
                                   atol=SIM_CAL_ATOL, rtol=0)
        n_admitted += tst.n_admitted
    captured = len(BATCHES) if every == 1 else 2     # batches 0 and 2
    assert 0 < len(tlog["admit"]) <= captured        # flushes that admitted
    assert n_admitted > 0 and sum(map(len, tlog["evict"])) > 0
    assert teng.sim_cal != seed[1]                   # recalibrated


@pytest.mark.parametrize("what", ["capture", "quanta"])
def test_run_layers_with_capture_or_quanta_makes_no_host_transfer(
        built, seed, what, monkeypatch):
    """The zero-per-layer-sync rule of the fast path (see
    ``test_torch_engine.py::test_run_layers_makes_no_host_transfer``)
    with miss capture on (kernel mode) and with ``device_quanta=4``
    (bucket mode): no ``.item()``, ``.cpu()``,
    ``.numpy()``, ``.tolist()`` or synchronize in ``run_layers``."""
    import repro_torch.core.engine as engine_mod
    jeng, teng0, queries = built
    capture = what == "capture"
    teng, _, _ = _fresh(jeng, teng0.model, seed, codec="int8", every=1,
                        mode="kernel" if capture else "bucket")
    teng.mc.admit = capture
    teng.mc.device_quanta = 1 if capture else 4
    prep = teng.prepare_batch({"tokens": queries[0]}, threshold=seed[2])
    assert prep.capture == capture
    calls = []
    for name in ("item", "cpu", "numpy", "tolist"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(self, *a, **k))
    monkeypatch.setattr(engine_mod, "synchronize",
                        lambda *a: calls.append("synchronize"))
    teng.run_layers(prep)
    assert calls == []
    monkeypatch.undo()
    out, st, payload = teng.finalize(prep)
    assert st.n_layer_attempts == 2 * 8 and out.shape == (8, 4)
    assert bool(payload.admissions) == capture   # mid threshold: misses
