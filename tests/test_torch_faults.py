"""The port's supervised maintenance and degradation ladder (the
``MemoServer`` cases of ``tests/test_faults.py``).

One session is built on the CPU as the reference's ``fault_engine`` is
(reduced bert_base: 2 layers, d 128, 4 heads, seq 32; bucket mode,
device slack 8, admission under a 64 MB budget, an idle fault injector)
and shared by the cases, each of which arms its faults through
``clean_faults``: healthy serving stays healthy; a crashing worker walks
HEALTHY → DEGRADED → MEMO_DISABLED, where every batch is served exact
(logits EQUAL to ``engine.infer(use_memo=False)``) until ``recover()``;
a transient sync failure is retried; queue overflow sheds payloads, not
requests; ``drain_maintenance`` times out under a stall and raises on a
dead worker with payloads pending.

The session-persistence cases follow: ``MemoSession.load`` fails with an
actionable ``MemoStoreError`` on truncated, bit-flipped and
spec-mismatched files and on an unknown format, the
``session.load_bitflip`` point hits the checksum gate, and a torn save
(``session.save_truncate``) never clobbers a good file in either format.
"""
import json
import os
import shutil
import time

import numpy as np
import pytest

from repro_torch.configs import get_reduced
from repro_torch.core.capacity import is_format3, read_format3, write_format3
from repro_torch.core.engine import MemoStats
from repro_torch.core.faults import FaultInjector, MemoStoreError
from repro_torch.core.runtime import Health, MemoMaintenanceError, MemoServer
from repro_torch.data import TemplateCorpus
from repro_torch.memo import MemoSession, MemoSpec
from repro_torch.models import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 32


@pytest.fixture(scope="module")
def fault_engine():
    cfg = get_reduced("bert_base").replace(n_classes=4, n_layers=2,
                                           d_model=128, d_ff=256, n_heads=4)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=6,
                            slot_fraction=0.2)
    model = build_model(cfg, device="cpu")
    spec = MemoSpec.flat(threshold=0.6, embed_steps=40, mode="bucket",
                         device_slack=8.0, admit=True, budget_mb=64.0,
                         faults={})
    sess = MemoSession.build(model, model.init(0), spec,
                             batches=[{"tokens": corpus.sample(16)[0]}
                                      for _ in range(3)],
                             seed=1, device="cpu")
    eng = sess.engine
    assert eng.faults is not None           # faults={} arms nothing but
    assert eng.store._faults is eng.faults  # builds the shared injector
    return eng, corpus


@pytest.fixture()
def clean_faults(fault_engine):
    eng = fault_engine[0]
    eng.faults.disarm()
    eng.faults.reset()
    yield eng.faults
    eng.faults.disarm()
    eng.faults.reset()


def _make_server(eng, **kw):
    return MemoServer(eng, buckets=(SEQ,), max_batch=8, max_delay=1e-4,
                      **kw)


def _serve_some(srv, corpus, n=4):
    comps = []
    for _ in range(n):
        toks = corpus.sample(8)[0]
        for r in range(8):
            srv.submit(np.asarray(toks[r], np.int32))
        comps.extend(srv.step(flush=True))
    return comps


def test_healthy_serving_stays_healthy(fault_engine, clean_faults):
    eng, corpus = fault_engine
    srv = _make_server(eng)
    try:
        comps = _serve_some(srv, corpus)
        srv.drain_maintenance(timeout=30)
        assert len(comps) == 32
        assert srv.health is Health.HEALTHY
        assert not srv.health_log           # no transitions at all
    finally:
        srv.close()


def test_maint_crash_disables_memo_and_serves_exact(fault_engine,
                                                    clean_faults):
    """Worker crashes exhaust retries -> DEGRADED -> MEMO_DISABLED; every
    request still completes, and MEMO_DISABLED logits equal the engine's
    no-memo path bit for bit."""
    eng, corpus = fault_engine
    clean_faults.arm("server.maint_crash", p=1.0)
    srv = _make_server(eng, maint_retries=1, maint_backoff_s=0.005,
                       disable_after=2)
    try:
        comps = _serve_some(srv, corpus, n=6)
        assert len(comps) == 48             # zero dropped requests
        deadline = time.monotonic() + 10
        while (srv.health is not Health.MEMO_DISABLED
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert srv.health is Health.MEMO_DISABLED, srv.health_log
        # the maintenance error keeps its traceback and names the
        # payload generation it was applying
        e0 = srv.maintenance_errors[0]
        assert isinstance(e0, MemoMaintenanceError)
        assert e0.__cause__ is not None
        assert "generation" in str(e0) and "attempt" in str(e0)
        # exact-attention parity while disabled
        toks = corpus.sample(8)[0]
        for r in range(8):
            srv.submit(np.asarray(toks[r], np.int32))
        got = srv.step(flush=True)
        assert srv.n_exact_batches >= 1
        batch = {"tokens": np.asarray(toks, np.int32),
                 "lengths": np.full(8, SEQ, np.int32), "n_valid": 8}
        ref = eng.infer(batch, stats=MemoStats(),
                        use_memo=False)[0].numpy()
        for i, c in enumerate(got):
            assert np.array_equal(c.logits, ref[i]), f"row {i} differs"
        # recover(): back to HEALTHY, memo path serves hits again
        clean_faults.disarm()
        info = srv.recover()
        assert srv.health is Health.HEALTHY
        assert info["live_entries"] > 0 and info["capacity_ok"] is None
        hits_before = srv.stats.n_hits
        _serve_some(srv, corpus, n=2)
        srv.drain_maintenance(timeout=30)
        assert srv.health is Health.HEALTHY
        assert srv.stats.n_hits > hits_before
    finally:
        srv.close()


def test_transient_failure_is_retried_to_success(fault_engine,
                                                 clean_faults):
    eng, corpus = fault_engine
    clean_faults.arm("store.sync_fail", p=1.0, count=1)
    srv = _make_server(eng, maint_retries=2, maint_backoff_s=0.005)
    try:
        _serve_some(srv, corpus, n=2)
        srv.drain_maintenance(timeout=30)
        assert srv.health is Health.HEALTHY, srv.health_log
        assert srv.n_maint_retries >= 1
        assert srv.maintenance_errors == []
    finally:
        srv.close()


def test_queue_overflow_sheds_payload_not_requests(fault_engine,
                                                   clean_faults):
    eng, corpus = fault_engine
    clean_faults.arm("server.queue_overflow", p=1.0)
    srv = _make_server(eng, maint_put_timeout=0.01)
    try:
        comps = _serve_some(srv, corpus, n=3)
        assert len(comps) == 24             # every request answered
        assert srv.n_maint_shed >= 1
        assert srv.health is Health.DEGRADED
        clean_faults.disarm()
        srv.recover()
        assert srv.health is Health.HEALTHY
    finally:
        srv.close()


def test_drain_timeout_and_stall_watchdog(fault_engine, clean_faults):
    eng, corpus = fault_engine
    clean_faults.arm("server.maint_stall", p=1.0, stall_s=0.3)
    srv = _make_server(eng, watchdog_s=0.05, maint_retries=0)
    try:
        _serve_some(srv, corpus, n=2)
        with pytest.raises(TimeoutError, match="timed out"):
            srv.drain_maintenance(timeout=0.01)
        clean_faults.disarm()
        srv.drain_maintenance(timeout=30)   # stall passes, then drains
    finally:
        srv.close()


def test_drain_raises_on_dead_worker_with_pending_payloads(fault_engine,
                                                           clean_faults):
    eng, corpus = fault_engine
    srv = _make_server(eng)
    try:
        _serve_some(srv, corpus, n=1)
        srv.drain_maintenance(timeout=30)
        # a hard worker death with work still queued: stop the worker,
        # then queue a payload nobody will take
        w = srv._worker
        srv.close()
        assert not w.is_alive()
        srv._worker = w
        srv._maint_q.put(object())
        with pytest.raises(MemoMaintenanceError, match="not alive"):
            srv.drain_maintenance(timeout=5)
        srv._maint_q.get_nowait()
        srv._maint_q.task_done()
    finally:
        srv.close()


# --------------------------------------------- session persistence faults

@pytest.fixture(scope="module")
def saved_store(fault_engine, tmp_path_factory):
    eng, _ = fault_engine
    eng.faults.disarm()
    path = str(tmp_path_factory.mktemp("faults") / "store.npz")
    MemoSession(eng).save(path)
    return path, eng.model, eng.params


def _load(path, m, params, **kw):
    return MemoSession.load(path, m, params, device="cpu", **kw)


def test_load_roundtrip(saved_store):
    path, m, params = saved_store
    sess = _load(path, m, params)
    assert sess.store.live_count > 0


def test_load_rejects_truncated_file(saved_store, tmp_path):
    path, m, params = saved_store
    torn = str(tmp_path / "torn.npz")
    shutil.copy(path, torn)
    with open(torn, "rb+") as f:
        f.truncate(os.path.getsize(torn) // 2)
    with pytest.raises(MemoStoreError, match="truncated or corrupt"):
        _load(torn, m, params)


def test_load_rejects_bitflip_on_disk(saved_store, tmp_path):
    path, m, params = saved_store
    flipped = str(tmp_path / "flip.npz")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(flipped, "wb").write(bytes(data))
    with pytest.raises(MemoStoreError):
        _load(flipped, m, params)


def test_load_bitflip_fault_point_hits_checksum_gate(saved_store):
    path, m, params = saved_store
    inj = FaultInjector()
    inj.arm("session.load_bitflip", at=1, count=1)
    with pytest.raises(MemoStoreError, match="checksum mismatch"):
        _load(path, m, params, faults=inj)
    # the injector is spent: the same file loads cleanly afterwards
    sess = _load(path, m, params, faults=inj)
    assert sess.store.live_count > 0


def test_save_truncate_fault_produces_torn_write(fault_engine,
                                                 clean_faults, tmp_path):
    eng, _ = fault_engine
    clean_faults.arm("session.save_truncate", at=1, count=1)
    torn = str(tmp_path / "torn.npz")
    MemoSession(eng).save(torn)
    with pytest.raises(MemoStoreError, match="truncated or corrupt"):
        _load(torn, eng.model, eng.params)


@pytest.mark.parametrize("save_format", [2, 3])
def test_torn_save_never_clobbers_existing_file(fault_engine, clean_faults,
                                                tmp_path, save_format):
    """Atomic save: the crash window between temp write and publish
    (session.save_truncate) leaves a previously saved GOOD file
    loadable."""
    eng, _ = fault_engine
    clean_faults.disarm()
    sess = MemoSession(eng)
    path = str(tmp_path / f"good_{save_format}.bin")
    sess.save(path, save_format=save_format)
    before = open(path, "rb").read()
    clean_faults.arm("session.save_truncate", at=1, count=1)
    sess.save(path, save_format=save_format)       # torn re-save
    assert open(path, "rb").read() == before       # old bytes intact
    loaded = _load(path, eng.model, eng.params)
    assert loaded.store.live_count == sess.store.live_count


def _rewrite_meta(path, out, mutate):
    if is_format3(path):
        meta, arrays = read_format3(path)
        mutate(meta)
        write_format3(out, meta, arrays)
        return
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        arrays = {k: data[k] for k in data.files if k != "meta"}
    mutate(meta)
    with open(out, "wb") as f:
        np.savez_compressed(f, meta=json.dumps(meta), **arrays)


def test_load_rejects_spec_mismatch(saved_store, tmp_path):
    path, m, params = saved_store
    bad = str(tmp_path / "mismatch.npz")
    _rewrite_meta(path, bad,
                  lambda meta: meta["spec"]["embed"].update(dim=999))
    with pytest.raises(MemoStoreError, match="saved under a different"):
        _load(bad, m, params)


def test_load_rejects_unknown_format(saved_store, tmp_path):
    path, m, params = saved_store
    bad = str(tmp_path / "fmt.npz")
    _rewrite_meta(path, bad, lambda meta: meta.update(format=999))
    with pytest.raises(MemoStoreError, match="format"):
        _load(bad, m, params)
