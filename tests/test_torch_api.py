"""The port's ``MemoSession.save``/``load`` (the save/load cases of
``tests/test_api.py``), on the CPU.

A session is built on the port's reduced bert_base (2 layers, d 128, 4
heads, seq 32; bucket mode, admission under a 64 MB budget), mutated by
one served batch, saved in format 3 and 2 and loaded (format 3 read and
mapped): host-tier lookups are BIT-identical (distances and slots),
entry lengths, ``sim_cal`` and codec round-trip, and both sessions
serve the same batch with equal hit rates and EQUAL logits (the same
arrays through the same code), then admit the same misses to equal
store state (over mapped arenas, growth copies them into RAM). The
reference's scale cases round-trip the same way: the lowrank codec, the
forced clustered device index (f16 and int8) and the ivf host index,
whose k-means layout must come back. A loaded session serves under
``MemoServer`` with the pre-save session's hit count on the same trace.
"""
import json

import numpy as np
import pytest

from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.memo import (AdmissionPolicy, CodecSpec, EmbedSpec,
                              IndexSpec, MemoSession, MemoSpec, RuntimeSpec)
from repro_torch.memo import registry as memo_registry
from repro_torch.models import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 32


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = get_reduced("bert_base").replace(n_classes=4, n_layers=2,
                                           d_model=128, d_ff=256,
                                           n_heads=4)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=6,
                            slot_fraction=0.2)
    return m, params, corpus


def _build_session(tiny_setup, codec, device_index="auto", crossover=4096,
                   host_index="exact"):
    m, params, corpus = tiny_setup
    spec = MemoSpec(
        runtime=RuntimeSpec(threshold=0.6, mode="bucket"),
        embed=EmbedSpec(steps=30),
        codec=CodecSpec(name=codec),
        index=IndexSpec(host=host_index, device=device_index,
                        cluster_crossover=crossover),
        admission=AdmissionPolicy(enabled=True, budget_mb=64.0))
    batches = [{"tokens": corpus.sample(16)[0]} for _ in range(3)]
    return MemoSession.build(m, params, spec, batches=batches, seed=1,
                             device="cpu")


@pytest.mark.parametrize("codec", ["f16", "int8"])
@pytest.mark.parametrize("fmt,mmap", [(3, False), (3, True), (2, False)])
def test_save_load_roundtrip_bit_identical(tiny_setup, tmp_path, codec,
                                           fmt, mmap):
    _roundtrip(tiny_setup, tmp_path, fmt, mmap, codec)


@pytest.mark.parametrize("codec,device_index,crossover,host", [
    ("lowrank", "auto", 4096, "exact"),
    ("int8", "clustered", 1, "exact"),   # forced clustered device index
    ("f16", "clustered", 1, "exact"),
    ("int8", "auto", 4096, "ivf")])      # the k-means layout round-trips
@pytest.mark.parametrize("fmt,mmap", [(3, True), (2, False)])
def test_save_load_scale_options_roundtrip(tiny_setup, tmp_path, codec,
                                           device_index, crossover, host,
                                           fmt, mmap):
    sess, loaded = _roundtrip(tiny_setup, tmp_path, fmt, mmap, codec,
                              device_index, crossover, host)
    for tier in ("index", "device_index"):
        assert type(getattr(loaded.store, tier)) is \
            type(getattr(sess.store, tier))
    if host == "ivf":
        assert loaded.store.index.n_lists == sess.store.index.n_lists


def _roundtrip(tiny_setup, tmp_path, fmt, mmap, codec, *index):
    """Build, serve, save, load; the two sessions must answer lookups
    and serve bit-identically and admit the same misses alike."""
    m, params, corpus = tiny_setup
    sess = _build_session(tiny_setup, codec, *index)
    toks = corpus.sample(8)[0]
    sess.infer({"tokens": toks})           # mutate: admissions land

    path = tmp_path / f"memo_{codec}.f{fmt}"
    sess.save(path, save_format=fmt)
    loaded = MemoSession.load(path, m, params, mmap=mmap, device="cpu")

    q = sess.store.embeddings_at(np.arange(min(8, len(sess.store.db))))
    d1, i1 = sess.store.lookup(q, 1)
    d2, i2 = loaded.store.lookup(q, 1)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)

    n = len(sess.store.db)
    np.testing.assert_array_equal(sess.store.entry_lengths(np.arange(n)),
                                  loaded.store.entry_lengths(np.arange(n)))
    assert sess.store.sim_cal == loaded.store.sim_cal
    assert loaded.store.codec.name == sess.store.codec.name
    if mmap:
        assert all(isinstance(a, np.memmap)
                   for a in loaded.store.db._arenas)

    out1, st1 = sess.infer({"tokens": toks})
    out2, st2 = loaded.infer({"tokens": toks})
    assert st1.memo_rate == st2.memo_rate
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())

    # both admitted the same misses; over adopted (mapped) arenas the
    # admission grew them into RAM arrays holding the mapped rows
    fresh = {"tokens": corpus.sample(8)[0]}
    sess.infer(fresh, threshold=1e9)
    loaded.infer(fresh, threshold=1e9)
    assert len(loaded.store.db) == len(sess.store.db) > n
    for k, v in sess.store.state_dict().items():
        np.testing.assert_array_equal(loaded.store.state_dict()[k], v,
                                      err_msg=k)
    if mmap:
        assert not any(isinstance(a, np.memmap)
                       for a in loaded.store.db._arenas)
    return sess, loaded


def test_loaded_session_serves_with_equal_hit_rate(tiny_setup, tmp_path):
    """A loaded session serves under MemoServer with the hit rate of the
    pre-save session on the same trace."""
    m, params, corpus = tiny_setup
    sess = _build_session(tiny_setup, "int8")
    sess.infer({"tokens": corpus.sample(8)[0]})
    path = tmp_path / "memo_serve.m3"
    sess.save(path)
    loaded = MemoSession.load(path, m, params, mmap=True, device="cpu")

    def serve_trace(session, seed=11):
        rng = np.random.default_rng(seed)
        with session.serve(buckets=(SEQ,), max_batch=8,
                           async_maintenance=False) as server:
            server.warmup()
            for _ in range(3):
                for _ in range(8):
                    server.submit(corpus.sample(1, rng)[0][0])
                server.step(flush=True)
            return server.stats.memo_rate, server.stats.n_hits

    rate_pre, hits_pre = serve_trace(sess)
    rate_post, hits_post = serve_trace(loaded)
    assert hits_pre > 0                       # the trace actually hits
    assert rate_pre == rate_post
    assert hits_pre == hits_post


def test_load_rejects_unknown_format(tiny_setup, tmp_path):
    path = tmp_path / "bad.npz"
    with open(path, "wb") as f:
        np.savez(f, meta=json.dumps({"format": 999}))
    m, params, _ = tiny_setup
    with pytest.raises(ValueError, match="format"):
        MemoSession.load(path, m, params, device="cpu")


def test_load_mmap_needs_format3(tiny_setup, tmp_path):
    m, params, _ = tiny_setup
    sess = _build_session(tiny_setup, "int8")
    path = tmp_path / "memo.npz"
    sess.save(path, save_format=2)
    with pytest.raises(ValueError, match="not format 3"):
        MemoSession.load(path, m, params, mmap=True, device="cpu")
    with pytest.raises(ValueError, match="save_format"):
        sess.save(path, save_format=1)


def test_memo_registry_reexports_core_registries():
    from repro_torch.core import registry as core
    for name in ("CODECS", "DEVICE_INDEXES", "EVICTIONS", "HOST_INDEXES",
                 "Registry", "register_codec", "register_eviction",
                 "register_index"):
        assert getattr(memo_registry, name) is getattr(core, name)
