"""The port's prefill serving, persistence and batch launcher against the
JAX package.

* ``MemoServer`` prefill requests against the JAX server under sync
  maintenance (equal per-request logits and caches within 1e-4; plain
  and prefill requests never share a batch), the refusal without a
  prefill spec, and the ``MEMO_DISABLED`` fallback to ``prefill_exact``;
* K/V-bearing entries through ``MemoSession.save``/``load`` in formats
  3 and 2, and save files crossing between the packages both ways;
  ``bridge.engine_from_reference`` carrying the appended K/V parts;
* ``train/checkpoint.py`` files crossing both ways (equal arrays, meta
  and optimizer state);
* ``launch/serve.py`` legs held to the reference's printed hit counts on
  state carried across: a checkpoint written by
  ``repro.train.checkpoint`` and a store saved by the reference's
  ``serve.py --save-store``, loaded by both launchers with an explicit
  threshold (default, ``--online``, ``--varlen`` parity and
  ``--selective``, whose timing-based active layers are pinned in both
  packages).

One JAX prefill engine (reduced gpt2_small, int8, seq 16) and one
reference launcher store (reduced bert_base, seq 16) are built per
module."""
import re
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import engine_from_reference
from repro_torch.configs import get_reduced
from repro_torch.core.prefill import PrefillCodec
from repro_torch.core.runtime import Health, MemoServer
from repro_torch.data import TemplateCorpus
from repro_torch.memo import MemoSession, MemoStats
from repro_torch.models import build_model
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 16
BATCH = 8
ATOL = 1e-4


@pytest.fixture(scope="module")
def built():
    """One JAX prefill session (reduced gpt2_small, int8 APM and K/V) and
    the port engine carried across from it."""
    from repro.configs import get_reduced as jax_reduced
    from repro.memo import MemoSession as JaxSession
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    jm = jax_build_model(jax_reduced("gpt2_small"), layer_loop="unroll")
    jp = jm.init(jax.random.PRNGKey(0))
    corpus = TemplateCorpus(vocab=512, seq_len=SEQ, n_templates=8,
                            slot_fraction=0.25, seed=3)
    rng = np.random.default_rng(17)
    calib = [corpus.sample(BATCH, rng)[0] for _ in range(2)]
    js = JaxSession.build(
        jm, jp, JaxSpec.flat(threshold=0.6, mode="bucket", embed_steps=40,
                             apm_codec="int8", prefill_enabled=True),
        batches=[{"tokens": jnp.asarray(t)} for t in calib],
        key=jax.random.PRNGKey(1))
    model = build_model(get_reduced("gpt2_small"), device="cpu")
    teng = engine_from_reference(js.engine, model, device="cpu")
    return js, teng, model, corpus, calib


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree))


def _drain(srv):
    comps = []
    while srv.queued:
        comps.extend(srv.step(flush=True))
    return {c.rid: c for c in comps}


# ----------------------------------------------------------- server layer

def test_server_prefill_serving(built):
    """Prefill requests come back with per-request decode caches equal to
    the JAX server's (logits and caches within 1e-4) that decode in
    lockstep with exact-prefill caches; plain requests carry none and
    never share a batch with prefill requests."""
    from repro.core.runtime import MemoServer as JaxServer
    js, teng, model, _, calib = built
    jeng = js.engine
    jeng.mc.mode = teng.mc.mode = "bucket"
    cal = np.asarray(calib[0])
    got = {}
    for name, srv in (("jax", JaxServer(jeng, buckets=(SEQ,), max_batch=4,
                                        async_maintenance=False)),
                      ("port", MemoServer(teng, buckets=(SEQ,), max_batch=4,
                                          async_maintenance=False))):
        try:
            rids_pf = [srv.submit(cal[i], prefill=True) for i in range(4)]
            rids_pl = [srv.submit(cal[i]) for i in range(2)]
            by_rid = _drain(srv)
            assert srv.n_batches == 2          # one batch of each kind
        finally:
            srv.close()
        assert all(by_rid[r].caches is None for r in rids_pl)
        got[name] = ([by_rid[r] for r in rids_pf],
                     [by_rid[r] for r in rids_pl])
    (jpf, jpl), (tpf, tpl) = got["jax"], got["port"]
    for j, t in zip(jpf, tpf):
        assert t.caches is not None and t.logits.shape == (512,)
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), rtol=0,
                                   atol=ATOL)
        tl, jl = _leaves(t.caches), _leaves(j.caches)
        assert [a.shape for a in tl] == [b.shape for b in jl]
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    for j, t in zip(jpl, tpl):
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), rtol=0,
                                   atol=ATOL)
    # per-request cache slices decode in lockstep with exact prefill
    le, ce = teng.prefill_exact({"tokens": cal[:4]})
    te = le.argmax(-1)
    by_li = teng._split_caches(ce)
    with torch.no_grad():
        for i, c in enumerate(tpf):
            lg, _ = model.decode_step(teng.params, te[i: i + 1][:, None],
                                      c.caches, SEQ)
            ce_i = teng._merge_caches(
                {li: {k: v[i: i + 1] for k, v in cc.items()}
                 for li, cc in by_li.items()})
            lge, _ = model.decode_step(teng.params, te[i: i + 1][:, None],
                                       ce_i, SEQ)
            assert float((lg - lge).abs().max()) <= 2e-2


def test_server_prefill_requires_enabled_spec(built):
    _, teng, _, _, calib = built
    srv = MemoServer(teng, buckets=(SEQ,), max_batch=4,
                     async_maintenance=False)
    try:
        teng.mc.prefill.enabled = False
        with pytest.raises(RuntimeError, match="prefill"):
            srv.submit(np.asarray(calib[0])[0], prefill=True)
    finally:
        teng.mc.prefill.enabled = True
        srv.close()


def test_server_prefill_memo_disabled_falls_back_exact(built):
    """With the memo path disabled, prefill requests serve through
    ``prefill_exact``: caches included, exact logits, equal to the JAX
    server's fallback."""
    from repro.core.runtime import Health as JaxHealth
    from repro.core.runtime import MemoServer as JaxServer
    js, teng, _, _, calib = built
    cal = np.asarray(calib[0])
    out = {}
    for name, srv, down in (
            ("jax", JaxServer(js.engine, buckets=(SEQ,), max_batch=4,
                              async_maintenance=False),
             JaxHealth.MEMO_DISABLED),
            ("port", MemoServer(teng, buckets=(SEQ,), max_batch=4,
                                async_maintenance=False),
             Health.MEMO_DISABLED)):
        try:
            srv.health = down
            rids = [srv.submit(cal[i], prefill=True) for i in range(2)]
            by_rid = _drain(srv)
            assert srv.n_exact_batches == 1
        finally:
            srv.close()
        out[name] = [by_rid[r] for r in rids]
    le, _ = teng.prefill_exact({"tokens": cal[:2]})
    for i, (j, t) in enumerate(zip(out["jax"], out["port"])):
        assert t.caches is not None
        np.testing.assert_allclose(t.logits, le.numpy()[i], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------- session layer

def _state_bytes(store):
    return {k: np.asarray(v).tobytes() for k, v in store.state_dict().items()}


def _prefill_hits(eng, toks):
    """Per-layer hit masks and slots of a memoized prefill (threshold
    -1e9: every length-matched row hits its nearest entry), and the
    logits."""
    prep = eng.prepare_batch({"tokens": toks}, threshold=-1e9, prefill=True)
    eng.run_layers(prep)
    hits = [(np.asarray(p[2]), np.asarray(p[3])) for p in prep.pend]
    (lg, _), _, _ = eng.finalize(prep, stats=None)
    return hits, np.asarray(lg)


def test_bridge_carries_prefill_store(built):
    """``engine_from_reference`` carries a built JAX prefill engine's
    store — the appended K/V parts among the codec parts — byte for
    byte."""
    js, teng, _, _, _ = built
    assert isinstance(teng.store.codec, PrefillCodec)
    assert teng.store.codec.key == js.store.codec.key
    assert len(teng.store.codec.parts) == 4         # codes, scales, kv, s
    assert _state_bytes(teng.store) == _state_bytes(js.store)


@pytest.mark.parametrize("fmt", [3, 2])
def test_session_save_load_roundtrips_kv(built, tmp_path, fmt):
    """Saving persists the K/V parts through ``state_dict``: the loaded
    port session serves prefill with equal hits and bit-equal logits."""
    _, teng, model, _, calib = built
    sess = MemoSession(teng)
    path = str(tmp_path / f"sess.m{fmt}")
    sess.save(path, save_format=fmt)
    sess2 = MemoSession.load(path, model, teng.params, device="cpu")
    assert isinstance(sess2.store.codec, PrefillCodec)
    assert _state_bytes(sess2.store) == _state_bytes(sess.store)
    with torch.no_grad():
        h1, l1 = _prefill_hits(teng, calib[0])
        h2, l2 = _prefill_hits(sess2.engine, calib[0])
    for (a, sa), (b, sb) in zip(h1, h2):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
    assert all(a.all() for a, _ in h1)
    np.testing.assert_array_equal(l1, l2)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_kv_save_files_cross_packages(built, tmp_path, direction):
    """A prefill session saved by one package loads in the other with its
    K/V parts and prefill spec intact: equal store arrays, equal hits and
    slots, logits within 1e-4."""
    from repro.memo import MemoSession as JaxSession
    js, teng, model, _, calib = built
    path = str(tmp_path / "cross.m3")
    if direction == "jax_to_port":
        js.save(path)
        dst = MemoSession.load(path, model, teng.params, device="cpu")
        jeng, peng = js.engine, dst.engine
        src_state = _state_bytes(js.store)
    else:
        MemoSession(teng).save(path)
        dst = JaxSession.load(path, js.engine.model, js.engine.params)
        jeng, peng = dst.engine, teng
        src_state = _state_bytes(teng.store)
    assert _state_bytes(dst.store) == src_state
    assert dst.spec.prefill.enabled is True
    assert dst.spec.prefill.kv_codec == "auto"
    assert type(dst.store.codec).__name__ == "PrefillCodec"
    jh, jl = _prefill_hits(jeng, jnp.asarray(calib[1]))
    with torch.no_grad():
        th, tl = _prefill_hits(peng, calib[1])
    for (a, sa), (b, sb) in zip(jh, th):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)


# ----------------------------------------------------------- checkpoints

def _ckpt_tree(rng):
    return {"embed": rng.standard_normal((5, 3)).astype(np.float32),
            "layers": {"seg0": {"l0": {
                "w": rng.standard_normal((2, 3, 4)).astype(np.float32),
                "b": np.arange(4, dtype=np.int32)}}},
            "none_leaf": None}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A checkpoint written by either package loads in the other: equal
    arrays (dtypes and nesting included), equal meta and optimizer
    state; the port's tensors land on the device asked for."""
    from repro.train import checkpoint as jck
    rng = np.random.default_rng(0)
    params = _ckpt_tree(rng)
    opt = {"m": {"embed": rng.standard_normal((5, 3)).astype(np.float32)},
           "t": np.asarray(7, np.int32)}
    meta = {"arch": "gpt2_small", "note": "crossing"}
    path = str(tmp_path / "ck")
    if direction == "jax_to_port":
        jck.save_checkpoint(path, jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, opt), step=3,
                            meta=meta)
        p2, o2, m2 = load_checkpoint(path, device="cpu")
        assert isinstance(p2["embed"], torch.Tensor)
        p2, o2 = (jax.tree.map(lambda t: t.numpy(), x) for x in (p2, o2))
    else:
        save_checkpoint(path, jax.tree.map(torch.from_numpy, params),
                        {"m": {"embed": torch.from_numpy(opt["m"]["embed"])},
                         "t": 7}, step=3, meta=meta)
        p2, o2, m2 = jck.load_checkpoint(path)
        p2, o2 = (jax.tree.map(np.asarray, x) for x in (p2, o2))
    assert m2 == {"step": 3, **meta}
    assert p2["none_leaf"] is None
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(o2["m"]["embed"], opt["m"]["embed"])
    assert int(o2["t"]) == 7


def test_checkpoint_model_roundtrip(tmp_path):
    """A port model's params through a checkpoint serve the same
    forward; ``load_checkpoint`` raises without a card unless asked for
    the CPU."""
    m = build_model(get_reduced("gpt2_small").replace(n_layers=2),
                    device="cpu")
    params = m.init(0)
    path = str(tmp_path / "m.npz")
    save_checkpoint(path, params, step=1)
    p2, o2, meta = load_checkpoint(path, device="cpu")
    assert o2 is None and meta == {"step": 1}
    toks = np.random.default_rng(0).integers(0, 512, (2, 8))
    with torch.no_grad():
        torch.testing.assert_close(m.forward(p2, {"tokens": toks})[0],
                                   m.forward(params, {"tokens": toks})[0],
                                   rtol=0, atol=0)
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_checkpoint(path)


# -------------------------------------------------------------- serve.py

LAUNCH = ["--requests", "8", "--batch", "4", "--seq", "16",
          "--calib-batches", "2"]


def _run_reference(argv, capsys):
    from repro.launch import serve as jserve
    with mock.patch.object(sys, "argv", ["serve"] + argv):
        jserve.main()
    return capsys.readouterr().out


def _run_port(argv, capsys):
    from repro_torch.launch import serve
    res = serve.main(argv + ["--device", "cpu"])
    return res, capsys.readouterr().out


@pytest.fixture(scope="module")
def launch_state(tmp_path_factory):
    """A checkpoint written by ``repro.train.checkpoint`` (reduced
    bert_base with a 4-class head, so that ``--online`` needs no
    training) and a store saved by the reference's ``serve.py
    --save-store``; the threshold sits in the widest gap of the first
    request batch's predicted sims on that store."""
    from repro.configs import get_reduced as jax_reduced
    from repro.launch import serve as jserve
    from repro.models import build_model as jax_build_model
    from repro.train.checkpoint import save_checkpoint as jax_save
    root = tmp_path_factory.mktemp("launch")
    ckpt = str(root / "bert.npz")
    jm = jax_build_model(jax_reduced("bert_base").replace(n_classes=4))
    jax_save(ckpt, jm.init(jax.random.PRNGKey(0)), step=0,
             meta={"arch": "bert_base"})
    store = str(root / "store.m3")
    with mock.patch.object(sys, "argv", ["serve"] + LAUNCH + [
            "--ckpt", ckpt, "--save-store", store, "--threshold", "0.5",
            "--no-memo", "--requests", "4"]):
        jserve.main()
    params, _, _ = load_checkpoint(ckpt, device="cpu")
    model = build_model(get_reduced("bert_base"), device="cpu")
    sess = MemoSession.load(store, model, params, device="cpu")
    corpus = TemplateCorpus(vocab=512, seq_len=SEQ, seed=1)
    for _ in range(2):                  # the launcher's calibration draws
        corpus.sample(4)
    st = MemoStats()
    sess.infer({"tokens": corpus.sample(4)[0]}, threshold=1e9, stats=st)
    s = np.sort(np.asarray(list(st.sims)))
    lo, hi = len(s) // 4, 3 * len(s) // 4
    i = lo + int(np.argmax(np.diff(s[lo:hi])))
    return dict(ckpt=ckpt, store=store,
                threshold=repr(float((s[i] + s[i + 1]) / 2)))


def _hits(out, tag="serve"):
    m = re.findall(rf"\[{tag}\] memo rate .*\(hits (\d+)/(\d+)\)", out)
    assert m, out
    return [tuple(map(int, x)) for x in m]


def _args(state, *extra):
    return LAUNCH + ["--load-store", state["store"], "--ckpt", state["ckpt"],
                     "--threshold", state["threshold"], *extra]


def test_serve_default_matches_reference(launch_state, capsys):
    argv = _args(launch_state)
    ref = _run_reference(argv, capsys)
    res, out = _run_port(argv, capsys)
    assert _hits(out) == _hits(ref) == [(res["hits"], res["attempts"])]
    assert 0 < res["hits"] < res["attempts"]
    assert "[device fast path]" in out and "device cpu" in out


def test_serve_varlen_matches_reference(launch_state, capsys):
    """``--varlen``: equal hit counts on padded variable-length batches,
    and the fast path within the reference's tolerance of select."""
    argv = _args(launch_state, "--varlen")
    ref = _run_reference(argv, capsys)
    res, out = _run_port(argv, capsys)
    assert _hits(out) == _hits(ref)
    assert res["varlen_max_dlogits"] <= 2e-3
    assert "varlen parity vs select" in ref


def test_serve_selective_matches_reference(launch_state, capsys,
                                           monkeypatch):
    """``--selective`` with the profiler's active layers pinned to every
    other layer in both packages (they come from wall-clock timings,
    which cannot match across frameworks): equal hits, and the port
    prints its PerfModel table."""
    from repro.core.selective import PerfModel as JaxPerfModel
    from repro_torch.core.selective import PerfModel
    pin = lambda self, scale=1.0: sorted(self.profiles)[::2]  # noqa: E731
    monkeypatch.setattr(JaxPerfModel, "active_layers", pin)
    monkeypatch.setattr(PerfModel, "active_layers", pin)
    argv = _args(launch_state, "--selective")
    ref = _run_reference(argv, capsys)
    res, out = _run_port(argv, capsys)
    assert "selective memo active layers: [0, 2]" in out
    assert "selective memo active layers: [0, 2]" in ref
    assert _hits(out) == _hits(ref)


def test_serve_online_matches_reference(launch_state, capsys):
    """``--online`` on the carried-across store and checkpoint (no head
    training): the frozen and adaptive passes' per-batch hit rates, the
    admission/eviction counts and the select parity equal the
    reference's."""
    argv = _args(launch_state, "--online", "--phase-batches", "3")
    ref = _run_reference(argv, capsys)
    res, out = _run_port(argv, capsys)

    def rates(text):
        return re.findall(r"\[online\] (\w+)\s+phase (\d): hit-rate ([\d. ]+)"
                          r"\s+\(steady", text)
    assert rates(out) == rates(ref) and len(rates(out)) == 4
    seen = [float(r) for *_, rs in rates(out) for r in rs.split()]
    assert 0 < sum(seen) < len(seen), rates(out)      # hits and misses
    store = re.compile(r"\[online\] store: (\d+) admitted, (\d+) evicted")
    assert store.findall(out) == store.findall(ref)
    assert res["online"]["admitted"] > 0
    assert "logits match select: True" in out
