"""The port's serving slice against the JAX engine, end to end.

One reference engine is built once (reduced bert_base: 2 layers, d 128,
4 heads, seq 32) and carried into the port on the CPU through the
bridge (weights, embedder, store state, ``sim_cal``). Both packages then
serve the same token batches in ``kernel`` and ``bucket`` mode and must
give EQUAL per-layer hit masks and matched slots, predicted sims within
1e-5 and logits within atol 1e-4 (f32 layers stacked twice; the
measured gap is ~1e-6). Thresholds sit away from every predicted sim:
±1e9, and one mid value whose margin to every sim is asserted ≥ 1e-3,
so an ulp of search arithmetic cannot flip a decision."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import engine_from_reference
from repro_torch.configs import get_reduced
from repro_torch.memo import MemoSpec
from repro_torch.memo.session import MemoSession
from repro_torch.models import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MARGIN = 1e-3
LOGIT_ATOL = 1e-4


def _cfgs():
    from repro.configs import get_reduced as jax_reduced
    kw = dict(n_classes=4, n_layers=2, d_model=128, d_ff=256, n_heads=4)
    return get_reduced("bert_base").replace(**kw), \
        jax_reduced("bert_base").replace(**kw)


@pytest.fixture(scope="module")
def built():
    from repro.core.engine import MemoEngine as JaxEngine
    from repro.data import TemplateCorpus
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    cfg, jcfg = _cfgs()
    jm = jax_build_model(jcfg, layer_loop="unroll")
    jeng = JaxEngine(jm, jm.init(jax.random.PRNGKey(0)),
                     JaxSpec.flat(threshold=0.6, embed_steps=40,
                                  mode="bucket"))
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=32, n_templates=6,
                            slot_fraction=0.2)
    jeng.build(jax.random.PRNGKey(1),
               [{"tokens": jnp.asarray(corpus.sample(16)[0])}
                for _ in range(3)])
    teng = engine_from_reference(jeng, build_model(cfg, device="cpu"),
                                 device="cpu")
    queries = [corpus.sample(8)[0] for _ in range(2)]
    return jeng, teng, queries


def _serve(eng, batch, thr):
    """prepare → run_layers → finalize → maintenance; returns logits and
    the per-layer (li, sims, hits, slots) as numpy."""
    prep = eng.prepare_batch(batch, threshold=thr)
    eng.run_layers(prep)
    pend = [(li, np.asarray(s), np.asarray(h), np.asarray(i))
            for li, s, h, i in prep.pend]
    out, st, payload = eng.finalize(prep)
    eng.apply_maintenance(payload, stats=st)
    return np.asarray(out), pend


def _mid_threshold(jeng, batch, serve=_serve):
    """A threshold inside a gap of the predicted sims, with every layer's
    sims at least MARGIN away from it and both outcomes present.
    ``serve(eng, batch, thr)`` returns (logits, per-layer (li, sims, hits,
    slots)); the fast path's by default."""
    _, pend = serve(jeng, batch, 1e9)
    s0 = np.sort(pend[0][1])
    mids = [(s0[i] + s0[i + 1]) / 2 for i in range(len(s0) - 1)
            if s0[i + 1] - s0[i] >= 2 * MARGIN]
    mids.sort(key=lambda m: abs(m - np.median(s0)))
    for thr in mids:
        _, pend = serve(jeng, batch, float(thr))
        sims = np.concatenate([p[1] for p in pend])
        hits = np.concatenate([p[2] for p in pend])
        if np.abs(sims - thr).min() >= MARGIN and 0 < hits.sum() < hits.size:
            return float(thr)
    pytest.fail("no threshold with a 1e-3 margin on this batch")


def _compare(jeng, teng, batch, thr):
    jl, jp = _serve(jeng, dict(batch, tokens=jnp.asarray(batch["tokens"])),
                    thr)
    tl, tp = _serve(teng, batch, thr)
    assert [p[0] for p in tp] == [p[0] for p in jp]
    for (li, js, jh, ji), (_, ts, th, ti) in zip(jp, tp):
        np.testing.assert_array_equal(th, jh, err_msg=f"hits layer {li}")
        np.testing.assert_array_equal(ti, ji, err_msg=f"slots layer {li}")
        np.testing.assert_allclose(ts, js, atol=1e-5, err_msg=f"sims {li}")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
    return np.concatenate([p[2] for p in tp])


@pytest.mark.parametrize("mode", ["kernel", "bucket"])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
def test_serving_matches_reference(built, mode, which):
    jeng, teng, queries = built
    jeng.mc.mode = teng.mc.mode = mode
    batch = {"tokens": queries[0]}
    thr = {"all_hit": -1e9, "all_miss": 1e9}.get(which)
    if thr is None:
        thr = _mid_threshold(jeng, {"tokens": jnp.asarray(queries[0])})
    hits = _compare(jeng, teng, batch, thr)
    if which == "all_hit":
        assert hits.all()
    elif which == "all_miss":
        assert not hits.any()
    else:
        assert 0 < hits.sum() < hits.size


@pytest.mark.parametrize("mode", ["kernel", "bucket"])
def test_varlen_serving_matches_reference(built, mode):
    """Padded variable-length rows: mask-aware embedding, the length
    gate (a short row never replays a full-length entry) and masked
    attention."""
    jeng, teng, queries = built
    jeng.mc.mode = teng.mc.mode = mode
    lengths = np.array([32, 20, 32, 9, 32, 32, 31, 1], np.int32)
    hits = _compare(jeng, teng, {"tokens": queries[1], "lengths": lengths},
                    -1e9)
    per_row = hits.reshape(2, 8)
    np.testing.assert_array_equal(per_row, np.broadcast_to(lengths == 32,
                                                           (2, 8)))


def test_plain_path_and_levels_match_reference(built):
    jeng, teng, queries = built
    jeng.mc.mode = teng.mc.mode = "kernel"
    jl, _ = jeng.infer({"tokens": jnp.asarray(queries[0])}, use_memo=False)
    tl, _ = teng.infer({"tokens": queries[0]}, use_memo=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    jlev = jeng.suggest_levels([{"tokens": jnp.asarray(q)}
                                for q in queries])
    tlev = teng.suggest_levels([{"tokens": q} for q in queries])
    for k in jlev:
        assert abs(jlev[k] - tlev[k]) < 1e-4, k


def test_run_layers_makes_no_host_transfer(built, monkeypatch):
    """The CPU form of the zero-per-layer-sync rule: no ``.item()``,
    ``.cpu()``, ``.numpy()``, ``.tolist()`` or synchronize inside
    ``run_layers`` (on the card chip_smoke.py runs it under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    import repro_torch.core.engine as engine_mod
    _, teng, queries = built
    teng.mc.mode = "kernel"
    prep = teng.prepare_batch({"tokens": queries[0]}, threshold=0.0)
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
    out, st, _ = teng.finalize(prep)
    assert st.n_layer_attempts == 2 * 8 and out.shape == (8, 4)


@pytest.mark.parametrize("codec", ["int8", "f16"])
def test_session_end_to_end_on_cpu(codec):
    """The slice through the public entry points, from scratch (random
    init, embedder trained by autograd): kernel mode and bucket mode on
    the same state agree within the int8 gap — kernel mode dequantizes
    in f32 while bucket mode's decode_rows rounds to f16 (~5e-4 of a
    probability), and both are held to the memo-free path's argmax."""
    cfg, _ = _cfgs()
    from repro_torch.data import TemplateCorpus
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=32, n_templates=6,
                            slot_fraction=0.2)
    model = build_model(cfg, device="cpu")
    calib = [{"tokens": corpus.sample(16)[0]} for _ in range(3)]
    sess = MemoSession.build(model, model.init(0),
                             MemoSpec.flat(embed_steps=20, mode="kernel",
                                           apm_codec=codec),
                             batches=calib, device="cpu")
    fresh = [{"tokens": corpus.sample(16)[0]} for _ in range(2)]
    levels = sess.autotune(fresh, "moderate")
    assert levels["aggressive"] <= levels["moderate"] <= \
        levels["conservative"]
    batch = calib[0]                          # replayed: exact matches
    k_logits, st = sess.infer(batch)
    assert st.memo_rate > 0
    sess.spec.runtime.mode = "bucket"
    b_logits, _ = sess.infer(batch)
    plain, _ = sess.infer(batch, use_memo=False)
    assert torch.isfinite(k_logits).all() and k_logits.shape == (16, 4)
    np.testing.assert_allclose(b_logits.numpy(), k_logits.numpy(),
                               atol=5e-3)
    assert (k_logits.argmax(-1) == plain.argmax(-1)).float().mean() >= 0.9
    s = sess.stats()
    assert s["n_inputs"] == 48 and s["store"]["codec"] == codec
    assert s["store"]["full_syncs"] == 1


def _reference_variant(jeng, **fields):
    """A JAX engine with ``jeng``'s weights, embedder and sim_cal whose
    store, made by the spec with ``fields`` changed, holds the same
    entries (the decoded APMs re-encoded by the new codec) and is
    synced."""
    from repro.core.engine import MemoEngine as JaxEngine
    spec = jeng.mc.copy()
    for k, v in fields.items():
        setattr(spec, k, v)
    eng = JaxEngine(jeng.model, jeng.params, spec)
    eng.embedder = jeng.embedder
    st = jeng.store
    n = len(st.db)
    eng.store = eng._make_store(st.apm_shape, capacity=n)
    eng.store.admit(st.db.get(np.arange(n), count_reuse=False),
                    st._embs_host[:n])
    eng.sim_cal = jeng.sim_cal
    eng.store.sync()
    return eng


def test_unported_paths_raise(built, monkeypatch):
    """What used to wait for the store's scale slice serves: a reference
    engine with the lowrank codec, the ivf host index or the clustered
    device index crosses over through ``engine_from_reference`` (the
    clustered one with the reference's built layout) and gives EQUAL
    hits and slots, sims within 1e-5 and logits within LOGIT_ATOL, on
    the fast path in kernel and bucket mode (the ivf index on the
    host-synchronous kernel path, which searches it) at a threshold
    with every sim ``MARGIN`` away. A build with no card and no device
    still raises."""
    from test_torch_select import _compare_host, _serve_host
    jeng, teng, queries = built
    batch = {"tokens": queries[0]}
    jbatch = {"tokens": jnp.asarray(queries[0])}
    host_serve = lambda e, b, t: _serve_host(e, b, t)[:2]  # noqa: E731
    for fields in ({"apm_codec": "lowrank"},
                   {"device_index": "clustered", "nprobe": 4},
                   {"index_kind": "ivf", "device_fast_path": False}):
        jv = _reference_variant(jeng, **fields)
        tv = engine_from_reference(jv, teng.model, device="cpu")
        assert tv.store.codec.key == jv.store.codec.key
        for tier in ("index", "device_index"):
            assert type(getattr(tv.store, tier)).__name__ == \
                type(getattr(jv.store, tier)).__name__
        host = fields.get("device_fast_path") is False
        for mode in ("kernel", "bucket"):
            jv.mc.mode = tv.mc.mode = mode
            if host:
                thr = _mid_threshold(jv, jbatch, serve=host_serve)
                hits = _compare_host(jv, tv, batch, thr)
            else:
                hits = _compare(jv, tv, batch, _mid_threshold(jv, jbatch))
            assert 0 < hits.sum() < hits.size, (fields, mode)
    cfg, _ = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MemoSession.build(build_model(cfg, device="cpu"), None,
                          batches=[])


@pytest.mark.parametrize("field, value, slice_name", [
    pytest.param("shards", 2, "sharded-store", id="shards-2-sharded-store"),
    pytest.param("prefill_enabled", True, "prefill",
                 id="prefill_enabled-True-prefill")])
def test_later_slice_opt_ins_raise(field, value, slice_name, built,
                                   monkeypatch):
    """A reference spec that opts into a later slice crosses over with its
    opt-in kept, and the engine takes it: both slices are ported. A
    sharded spec (every ``ShardSpec`` field crossing over) builds a
    ``ShardedMemoStore`` — over two CPU shards through a patched
    ``make_store_mesh`` — that serves a batch with the flat engine's hits
    and slots at full routing. A prefill spec crosses over with every
    prefill field (its store wraps the APM codec in a
    ``PrefillCodec``)."""
    from repro.memo import MemoSpec as JaxSpec
    from repro_torch.core.engine import MemoEngine
    spec = MemoSpec.from_dict(JaxSpec.flat(**{field: value}).to_dict())
    assert getattr(spec, field) == value
    spec2 = MemoSpec.flat()
    setattr(spec2, field, value)                  # write-through property
    assert spec2 == spec
    cfg, _ = _cfgs()
    if slice_name == "sharded-store":
        import repro_torch.core.shard as shard
        jspec = JaxSpec.flat(shards=2, shard_axis="s", shard_hot=5,
                             shard_route_nprobe=7, shard_refresh_spills=3)
        assert MemoSpec.from_dict(jspec.to_dict()).to_dict()["shard"] \
            == jspec.to_dict()["shard"]
        monkeypatch.setattr(
            shard, "make_store_mesh", lambda n=None, axis="store",
            device=None: shard.StoreMesh(("cpu",) * n, axis))
        jeng, teng, queries = built
        sspec = teng.mc.copy()
        sspec.shards, sspec.shard_route_nprobe = value, 10 ** 6
        seng = engine_from_reference(jeng, build_model(cfg, device="cpu"),
                                     device="cpu", spec=sspec)
        assert isinstance(seng.store, shard.ShardedMemoStore)
        assert seng.store.n_shards == 2
        teng.mc.mode = seng.mc.mode = "bucket"
        batch = {"tokens": queries[1]}
        thr = _mid_threshold(teng, batch)
        tl, tp = _serve(teng, batch, thr)
        sl, sp = _serve(seng, batch, thr)
        for (li, _, th, ti), (_, _, sh, si) in zip(tp, sp):
            np.testing.assert_array_equal(sh, th, err_msg=f"hits {li}")
            np.testing.assert_array_equal(si, ti, err_msg=f"slots {li}")
        np.testing.assert_allclose(sl, tl, rtol=0, atol=LOGIT_ATOL)
        return
    from repro_torch.configs import get_reduced as reduced
    from repro_torch.core.prefill import PrefillCodec
    assert spec.to_dict()["prefill"] == JaxSpec.flat(
        **{field: value}).to_dict()["prefill"]
    gpt = reduced("gpt2_small").replace(n_layers=1, d_model=64, n_heads=2,
                                        n_kv_heads=2, d_ff=64)
    eng = MemoEngine(build_model(gpt, device="cpu"), None, spec)
    store = eng._make_store((gpt.n_heads, 8, 8), capacity=2)
    assert isinstance(store.codec, PrefillCodec)
    assert store.codec.kv_dim == gpt.n_kv_heads * gpt.head_dim


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, imported in a fresh interpreter, leaves
    ``jax`` and the reference package out of ``sys.modules``."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "    m.startswith('jax.') or m == 'repro' or\n"
        "    m.startswith('repro.'))\n"
        "assert len(names) > 20, names\n"
        "assert {'repro_torch.models.rwkv',\n"
        "        'repro_torch.kernels.flash_attention.ops',\n"
        "        'repro_torch.kernels.rwkv6.ops',\n"
        "        'repro_torch.core.runtime',\n"
        "        'repro_torch.core.capacity',\n"
        "        'repro_torch.core.shard',\n"
        "        'repro_torch.memo.registry',\n"
        "        'repro_torch.memo.session',\n"
        "        'repro_torch.launch.server',\n"
        "        'repro_torch.core.prefill',\n"
        "        'repro_torch.launch.serve',\n"
        "        'repro_torch.train.checkpoint',\n"
        "        'repro_torch.configs.qwen2_1_5b',\n"
        "        'repro_torch.configs.qwen3_8b',\n"
        "        'repro_torch.configs.deepseek_7b',\n"
        "        'repro_torch.configs.chameleon_34b',\n"
        "        'repro_torch.models.moe',\n"
        "        'repro_torch.configs.minicpm3_4b',\n"
        "        'repro_torch.configs.dbrx_132b',\n"
        "        'repro_torch.configs.kimi_k2_1t_a32b',\n"
        "        'repro_torch.configs.recurrentgemma_2b',\n"
        "        'repro_torch.configs.whisper_medium',\n"
        "        'repro_torch.models.rglru',\n"
        "        'repro_torch.models.encdec',\n"
        "        'repro_torch.optim.adafactor',\n"
        "        'repro_torch.optim.schedule',\n"
        "        'repro_torch.train.trainer',\n"
        "        'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.steps',\n"
        "        'repro_torch.sharding.rules',\n"
        "        'repro_torch.launch.train'} <= set(names), names\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_public_attributes_match_reference(built):
    """The attributes the reference's code, tests and benchmarks read,
    read the same way on both engines of the bridged pair:
    ``MemoEngine.device_index``, ``DeviceDB.apms``/``dtype``/
    ``entry_nbytes``/``nbytes``, ``MemoStore.logical_entry_nbytes``,
    ``MaintenancePayload.empty`` and ``Embedder.__call__``."""
    from repro.core.engine import MaintenancePayload as JaxPayload
    from repro_torch.core.engine import MaintenancePayload
    jeng, teng, queries = built
    jeng.mc.mode = teng.mc.mode = "bucket"
    jeng.store.sync()
    teng.store.sync()
    assert type(teng.device_index).__name__ == \
        type(jeng.device_index).__name__
    assert teng.device_index is teng.store.device_index
    assert len(teng.device_index) == len(jeng.device_index)
    jdb, tdb = jeng.device_db, teng.device_db
    assert str(tdb.dtype).removeprefix("torch.") == str(jdb.dtype)
    assert tdb.entry_nbytes == jdb.entry_nbytes
    assert tdb.nbytes == jdb.nbytes
    np.testing.assert_array_equal(tdb.apms.cpu().numpy(),
                                  np.asarray(jdb.apms))
    assert teng.store.logical_entry_nbytes == \
        jeng.store.logical_entry_nbytes
    for P in (JaxPayload, MaintenancePayload):
        assert P().empty
        assert P(reuse_slots=np.zeros(0, np.int64)).empty
        assert not P(reuse_slots=np.array([3])).empty
        assert not P(admissions=[(None, None, None, None)]).empty
    hid = np.random.default_rng(3).standard_normal(
        (4, 32, 128)).astype(np.float32)
    lens = np.array([32, 20, 9, 32], np.int32)
    for ln in (None, lens):
        want = np.asarray(jeng.embedder(
            jnp.asarray(hid), None if ln is None else jnp.asarray(ln)))
        got = teng.embedder(torch.from_numpy(hid), ln)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
