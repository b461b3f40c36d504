"""The port's memoized prefill against the JAX package (the ported
``tests/test_prefill.py`` cases on the same inputs and bridged state).

Covers the ``PrefillCodec`` (codec bytes equal to the reference's for
every KV mode; the f16 and int8 K/V decode bit-equal to numpy's, lowrank
within one f16 ulp), the zero-KV fallback and shape guard, ``stack_kv`` /
``unstack_kv_rows``, ``PrefillSpec``'s flat fields and their crossing in
both directions; ``Model.prefill`` + ``decode_step`` against the full
forward and the JAX model within 1e-4 (MHA, GQA, a sliding window,
rwkv6); the engine's ``prefill`` and ``prefill_exact`` against a JAX
engine carried across by the bridge (equal hits and slots, last-token
logits and caches within 1e-4, bucket and kernel mode); the self-hit
decode parity per codec inside the reference's bounds; the miss path,
the length gate, the causal gate and capture gating; and admission of
K/V-bearing entries by prefill batches.

One JAX engine (reduced gpt2_small, int8, seq 16) is built per module;
the per-codec self-hit cases build port sessions (no JAX)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prefill as jpf
from repro.core.codec import get_codec as jax_get_codec
from repro_torch.bridge import engine_from_reference, tree_to_torch
from repro_torch.configs import get_reduced
from repro_torch.core.codec import get_codec
from repro_torch.core.engine import MemoEngine, MemoStats
from repro_torch.core.prefill import PrefillCodec, stack_kv, unstack_kv_rows
from repro_torch.data import TemplateCorpus
from repro_torch.memo import MemoSession, MemoSpec
from repro_torch.models import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 16
BATCH = 8
KV_DIM = 12
ATOL = 1e-4           # port vs reference: f32 logits and caches

# per-codec |Δlogits| ceilings of the reference's test_prefill.py (the
# serve_prefill benchmark's gates): prefill carries the APM codec's
# error, decode the K/V codec's
BOUNDS = {
    "f16":     {"prefill": 5e-3, "decode": 5e-3},
    "int8":    {"prefill": 2e-2, "decode": 2e-2},
    "lowrank": {"prefill": 1e-1, "decode": 5e-2},
}


def _f16_ulp(x):
    """One f16 ulp at |x| (the spacing at the value's binade)."""
    return np.spacing(np.abs(np.asarray(x, np.float16))).astype(np.float32)


# ------------------------------------------------------------ codec layer

def _kv_plane(rng, b, s=SEQ, d=KV_DIM):
    return rng.normal(0, 1.5, (b, 2, s, d)).astype(np.float32)


@pytest.mark.parametrize("kv_mode", ["f16", "int8", "lowrank"])
def test_prefill_codec_roundtrip(kv_mode):
    """Encode is byte-equal to the reference's; the host decode equals
    the reference's host decode; the torch decode is bit-equal to it for
    f16 and int8, within one f16 ulp for lowrank (the factor product sums
    in another order); the round trip stays within the codec's error."""
    rng = np.random.default_rng(0)
    rank = SEQ if kv_mode == "lowrank" else None
    base = get_codec("int8", (2, SEQ, SEQ))
    c = PrefillCodec(base, KV_DIM, kv_codec=kv_mode, kv_rank=rank)
    jc = jpf.PrefillCodec(jax_get_codec("int8", (2, SEQ, SEQ)), KV_DIM,
                          kv_codec=kv_mode, kv_rank=rank)
    assert c.parts[: c.n_base_parts] == base.parts    # KV strictly appended
    assert [(p.name, p.shape, p.dtype) for p in c.parts] == \
        [(p.name, p.shape, p.dtype) for p in jc.parts]
    assert c.name == base.name == "int8"               # kernel branches on it
    assert c.key == jc.key and c.kv_rank == jc.kv_rank
    apms = rng.random((3, 2, SEQ, SEQ)).astype(np.float16)
    kv = _kv_plane(rng, 3)
    parts = c.encode(apms, aux=kv)
    jparts = jc.encode(apms, aux=kv)
    assert len(parts) == len(jparts)
    for a, b in zip(parts, jparts):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()
    np.testing.assert_array_equal(
        np.asarray(c.decode(parts)),
        np.asarray(base.decode(base.encode(apms))))
    host = c.decode_kv(parts)
    np.testing.assert_array_equal(host, jc.decode_kv(jparts))
    scale = float(np.abs(kv).max())
    tol = (1e-3 if kv_mode == "f16" else 0.05) * scale
    assert np.abs(host.astype(np.float32) - kv).max() < tol
    dev = c.decode_kv_rows(tuple(torch.from_numpy(p) for p in parts))
    assert dev.dtype == torch.float16
    dev = dev.numpy()
    if kv_mode == "lowrank":
        gap = np.abs(dev.astype(np.float32) - host.astype(np.float32))
        assert (gap <= _f16_ulp(host)).all(), gap.max()
    else:
        np.testing.assert_array_equal(dev, host)
    # the APM rows keep the base codec's device decode
    np.testing.assert_array_equal(
        c.decode_rows(tuple(torch.from_numpy(p) for p in parts)).numpy(),
        np.asarray(base.decode(base.encode(apms))))


def test_prefill_codec_zero_fallback_and_shape_guard():
    base = get_codec("f16", (2, SEQ, SEQ))
    c = PrefillCodec(base, KV_DIM)
    assert c.kv_mode == "f16"                   # auto follows the base
    assert PrefillCodec(get_codec("lowrank", (2, SEQ, SEQ)),
                        KV_DIM).kv_mode == "int8"
    assert PrefillCodec(base, KV_DIM, kv_rank=4).kv_mode == "lowrank"
    apms = np.random.default_rng(1).random((2, 2, SEQ, SEQ)) \
        .astype(np.float16)
    parts = c.encode(apms)                 # aux=None: APM-only admission
    assert np.abs(np.asarray(c.decode_kv(parts))).max() == 0.0
    with pytest.raises(ValueError, match="kv aux shape"):
        c.encode(apms, aux=np.zeros((2, 2, SEQ, KV_DIM + 1), np.float32))
    with pytest.raises(ValueError, match="no KV suffix"):
        c.decode_kv(parts[: c.n_base_parts])


def test_stack_unstack_kv_inverse():
    rng = np.random.default_rng(2)
    hkv, dh = 3, 4
    k = rng.normal(size=(2, SEQ, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(2, SEQ, hkv, dh)).astype(np.float32)
    kv = stack_kv(k, v)
    assert kv.shape == (2, 2, SEQ, hkv * dh)
    np.testing.assert_array_equal(kv, jpf.stack_kv(k, v))
    kt = stack_kv(torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(kt.numpy(), kv)
    k2, v2 = unstack_kv_rows(torch.from_numpy(kv), hkv, dh)
    np.testing.assert_array_equal(k2.numpy(), k)
    np.testing.assert_array_equal(v2.numpy(), v)


# ------------------------------------------------------------- spec layer

def test_prefill_spec_flat_fields_and_roundtrip():
    from repro.memo import MemoSpec as JaxSpec
    spec = MemoSpec.flat(threshold=0.5)
    assert spec.prefill.enabled is False        # inert by default
    spec = MemoSpec.flat(prefill_enabled=True, prefill_cache_len=64,
                         prefill_kv_codec="int8", prefill_kv_rank=6)
    assert spec.prefill.enabled and spec.prefill.cache_len == 64
    assert spec.prefill_kv_codec == "int8"      # flat attribute view
    assert spec.prefill_kv_rank == 6
    back = MemoSpec.from_dict(spec.to_dict())
    assert back == spec
    # both directions across the packages, every prefill field kept
    jspec = JaxSpec.from_dict(spec.to_dict())
    assert jspec.to_dict()["prefill"] == spec.to_dict()["prefill"]
    assert MemoSpec.from_dict(jspec.to_dict()) == spec
    with pytest.raises(ValueError, match="kv_codec"):
        MemoSpec.flat(prefill_kv_codec="int4")
    with pytest.raises(ValueError, match="cache_len"):
        MemoSpec.flat(prefill_cache_len=0)
    with pytest.raises(ValueError, match="kv_rank"):
        spec.prefill_kv_rank = 0                # write-through re-validates
    assert spec.prefill_kv_rank == 6


# ------------------------------------------ backbone prefill and decode

@pytest.mark.parametrize("arch,over", [
    ("gpt2_small", {}),                        # MHA
    ("gpt2_small", {"n_kv_heads": 2}),         # GQA: 4 heads over 2 KV
    ("gpt2_small", {"sliding_window": 8}),     # local attention window
    ("rwkv6_3b", {}),                          # recurrent state
])
def test_model_prefill_decode_matches_full_forward(arch, over):
    """prefill(S0) + K decode steps reproduce the full forward position
    by position, and match the JAX model's prefill/decode_step (logits
    and every cache leaf) within 1e-4, on the same weights."""
    from repro.configs import get_reduced as jax_reduced
    from repro.models import build_model as jax_build_model
    over = dict(over, n_layers=2)
    cfg = get_reduced(arch).replace(**over)
    jm = jax_build_model(jax_reduced(arch).replace(**over),
                         layer_loop="unroll")
    jp = jm.init(jax.random.PRNGKey(0))
    jprefill = jax.jit(functools.partial(jm.prefill, cache_len=12))
    jdecode = jax.jit(jm.decode_step)
    m = build_model(cfg, device="cpu")
    params = tree_to_torch(jp, "cpu")
    rng = np.random.default_rng(5)
    s0, steps = 8, 4                  # cache_len 12 = s0 + steps
    toks = rng.integers(0, cfg.vocab, (2, s0 + steps)).astype(np.int32)
    with torch.no_grad():
        full = m.forward(params, {"tokens": toks})[0].numpy()
        lg, caches = m.prefill(params, {"tokens": toks[:, :s0]},
                               cache_len=s0 + steps)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :s0])})

    def check(lg, caches, jl, jc, want, what):
        np.testing.assert_allclose(lg.numpy(), want, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{what} vs full forward")
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"{what} vs JAX")
        leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), caches))
        jleaves = jax.tree.leaves(jc)
        assert len(leaves) == len(jleaves)
        for a, b in zip(leaves, jleaves):
            b = np.asarray(b)
            assert a.shape == b.shape
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * scale,
                                       err_msg=f"{what} cache")

    check(lg, caches, jl, jc, full[:, s0 - 1], "prefill")
    for k in range(steps):
        tok = toks[:, s0 + k][:, None]
        with torch.no_grad():
            lg, caches = m.decode_step(params, tok, caches, s0 + k)
        jl, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.int32(s0 + k))
        check(lg, caches, jl, jc, full[:, s0 + k], f"decode step {k}")


def test_decode_step_takes_a_tensor_position():
    """``pos`` as a 0-d tensor gives the same step as the int."""
    cfg = get_reduced("gpt2_small").replace(n_layers=2)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9))
    with torch.no_grad():
        _, c = m.prefill(params, {"tokens": toks[:, :8]}, cache_len=4)
        a, ca = m.decode_step(params, toks[:, 8:], c, 8)
        b, cb = m.decode_step(params, toks[:, 8:], c, torch.tensor(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ca, cb, rtol=0, atol=0)


# ----------------------------------------------------------- engine layer

@pytest.fixture(scope="module")
def built():
    """One JAX prefill engine (reduced gpt2_small, int8 APM, int8 K/V)
    and the port engine carried across from it by the bridge."""
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
    teng = engine_from_reference(
        js.engine, build_model(get_reduced("gpt2_small"), device="cpu"),
        device="cpu")
    return js.engine, teng, corpus, calib


def _jax_prefill(jeng, toks, thr, lengths=None):
    from repro.memo import MemoStats as JaxStats
    batch = {"tokens": jnp.asarray(toks)}
    if lengths is not None:
        batch["lengths"] = lengths
    prep = jeng.prepare_batch(batch, threshold=thr, prefill=True)
    jeng.run_layers(prep)
    pend = [(np.asarray(p[1]), np.asarray(p[2]), np.asarray(p[3]))
            for p in prep.pend]
    (lg, caches), st, payload = jeng.finalize(prep, stats=JaxStats())
    jeng.apply_maintenance(payload, stats=st)
    return np.asarray(lg), caches, pend


def _port_prefill(teng, toks, thr, lengths=None):
    batch = {"tokens": toks}
    if lengths is not None:
        batch["lengths"] = lengths
    prep = teng.prepare_batch(batch, threshold=thr, prefill=True)
    teng.run_layers(prep)
    pend = [(p[1].numpy(), p[2].numpy(), p[3].numpy()) for p in prep.pend]
    (lg, caches), st, payload = teng.finalize(prep, stats=MemoStats())
    teng.apply_maintenance(payload, stats=st)
    return lg.numpy(), caches, pend


def _mid_threshold(pend):
    """A threshold inside a gap of layer 0's predicted sims with both
    outcomes present there and every layer's sims at least 1e-3 away, so
    an ulp of search arithmetic cannot flip a decision."""
    s0 = np.sort(pend[0][0])
    sims = np.concatenate([p[0] for p in pend])
    mids = sorted(((s0[i + 1] - s0[i], (s0[i] + s0[i + 1]) / 2)
                   for i in range(len(s0) - 1)), reverse=True)
    for _, thr in mids:
        if np.abs(sims - thr).min() >= 1e-3:
            return float(thr)
    pytest.fail(f"no threshold with a 1e-3 margin: {s0}")


@pytest.mark.parametrize("mode", ["bucket", "kernel"])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
def test_engine_prefill_matches_reference(built, mode, which):
    """Memoized prefill in both packages on the same state: equal hits
    and slots per layer, sims within 1e-5, last-token logits and every
    cache leaf within 1e-4. Kernel-mode engines take the same bucketed
    form for prefill (memo_attention hands back no K/V)."""
    jeng, teng, corpus, calib = built
    jeng.mc.mode = teng.mc.mode = mode
    toks = calib[0] if which == "all_hit" else corpus.sample(BATCH)[0]
    thr = {"all_hit": -1e9, "all_miss": 1e9}.get(which)
    if thr is None:
        thr = _mid_threshold(_jax_prefill(jeng, toks, 1e9)[2])
    jl, jc, jp = _jax_prefill(jeng, toks, thr)
    tl, tc, tp = _port_prefill(teng, toks, thr)
    assert len(tp) == len(jp) == len(teng.layers)
    for li, ((js, jh, ji), (ts, th, ti)) in enumerate(zip(jp, tp)):
        np.testing.assert_array_equal(th, jh, err_msg=f"hits layer {li}")
        np.testing.assert_array_equal(ti, ji, err_msg=f"slots layer {li}")
        np.testing.assert_allclose(ts, js, atol=1e-5, err_msg=f"sims {li}")
    hits = np.stack([p[1] for p in tp])
    if which == "all_hit":
        assert hits.all()
    elif which == "all_miss":
        assert not hits.any()
    else:
        assert 0 < hits[0].sum() < hits[0].size
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tc))
    jleaves = jax.tree.leaves(jc)
    assert [a.shape for a in leaves] == [np.shape(b) for b in jleaves]
    assert leaves[0].shape[2] == 2 * SEQ              # 2·S headroom
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)
    # the exact leg: Model.prefill in both packages
    je, jce = jeng.prefill_exact({"tokens": jnp.asarray(toks)})
    te, tce = teng.prefill_exact({"tokens": toks})
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=ATOL)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tce)),
                    jax.tree.leaves(jce)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


def test_hit_cache_is_the_stored_kv(built):
    """A hit layer's decode cache is the plain decode of its matched
    entry's stored K/V (then zero to ``cache_len``); the stored K/V lie
    within int8 row quantization of the exact K/V."""
    _, teng, _, calib = built
    teng.mc.mode = "bucket"
    lm, cm, st = teng.prefill({"tokens": calib[0]}, threshold=-1e9)
    le, ce = teng.prefill_exact({"tokens": calib[0]})
    by_li, by_li_e = teng._split_caches(cm), teng._split_caches(ce)
    store = teng.store
    idx = torch.arange(BATCH)       # calibration batch 0 is slots 0..B-1
    for li in teng.layers:
        rows = tuple(p[idx + li * BATCH] for p in store.device_db.parts)
        kv = store.codec.decode_kv_rows(rows).float()
        k, v = unstack_kv_rows(kv, 4, 64)
        torch.testing.assert_close(by_li[li]["k"][:, :SEQ], k, rtol=0,
                                   atol=0)
        torch.testing.assert_close(by_li[li]["v"][:, :SEQ], v, rtol=0,
                                   atol=0)
        assert by_li[li]["k"][:, SEQ:].abs().max() == 0
        # per stored row (one position of one plane, all heads): half an
        # int8 step, plus two f16 roundings (the plane staged in f16
        # before encoding, the f16 decode) of up to 2^-11 of |x| <= 127
        # steps each
        for got, ex in ((k, by_li_e[li]["k"]), (v, by_li_e[li]["v"])):
            ex = ex[:, :SEQ].flatten(2)
            step = ex.abs().amax(-1) / 127.0
            err = (got.flatten(2) - ex).abs().amax(-1)
            assert (err <= (0.5 + 2 * 127 * 2.0 ** -11) * step).all(), \
                (err / step).max()


@functools.lru_cache(maxsize=3)
def _port_session(codec: str):
    """A port-built prefill session over the reduced gpt2_small."""
    cfg = get_reduced("gpt2_small")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=8,
                            slot_fraction=0.25, seed=3)
    lowrank = codec == "lowrank"
    spec = MemoSpec.flat(
        threshold=0.6, mode="bucket", embed_steps=40, apm_codec=codec,
        apm_rank=(3 * SEQ) // 4 if lowrank else None, prefill_enabled=True,
        prefill_kv_codec="lowrank" if lowrank else "auto",
        prefill_kv_rank=SEQ if lowrank else None)
    rng = np.random.default_rng(17)
    calib = [corpus.sample(BATCH, rng)[0] for _ in range(2)]
    sess = MemoSession.build(model, params, spec,
                             batches=[{"tokens": t} for t in calib], seed=1,
                             device="cpu")
    return sess, model, corpus, calib


def _teacher_forced_decode(eng, model, lm, cm, le, ce, steps):
    """Greedy decode both cache sets on the exact leg's tokens; returns
    (max |Δlogits| across steps, agreement fraction)."""
    dmax, agree, total = 0.0, 0, 0
    with torch.no_grad():
        for step in range(steps):
            tm = lm.argmax(-1).reshape(-1)
            te = le.argmax(-1).reshape(-1)
            agree += int((tm == te).sum())
            total += int(te.shape[0])
            lm, cm = model.decode_step(eng.params, te[:, None], cm,
                                       SEQ + step)
            le, ce = model.decode_step(eng.params, te[:, None], ce,
                                       SEQ + step)
            dmax = max(dmax, float((lm - le).abs().max()))
    return dmax, agree / max(1, total)


@pytest.mark.parametrize("codec", ["f16", "int8", "lowrank"])
def test_prefill_selfhit_decode_parity(codec):
    """Replaying an admitted prompt hits every memoized layer, and the
    decode cache from the stored K/V carries greedy decode inside the
    reference's per-codec bounds."""
    sess, model, _, calib = _port_session(codec)
    eng = sess.engine
    batch = {"tokens": calib[0]}
    le, ce = eng.prefill_exact(batch)
    lm, cm, st = eng.prefill(batch, threshold=-1e9)
    assert st.n_layer_attempts > 0
    assert st.n_hits == st.n_layer_attempts          # pure self-hits
    b = BOUNDS[codec]
    assert float((lm - le).abs().max()) <= b["prefill"]
    dmax, agree = _teacher_forced_decode(eng, model, lm, cm, le, ce, 4)
    assert dmax <= b["decode"]
    assert agree >= (1.0 if codec == "f16" else 0.9)


def test_prefill_miss_matches_exact():
    """All-miss prefill runs the exact layer bodies: logits match
    ``prefill_exact`` and the decode caches agree."""
    sess, model, corpus, _ = _port_session("int8")
    eng = sess.engine
    batch = {"tokens": corpus.sample(4)[0]}
    le, ce = eng.prefill_exact(batch)
    lm, cm, st = eng.prefill(batch, threshold=1e9)
    assert st.n_hits == 0
    torch.testing.assert_close(lm, le, rtol=2e-3, atol=2e-3)
    dmax, agree = _teacher_forced_decode(eng, model, lm, cm, le, ce, 2)
    assert dmax <= 2e-3 and agree == 1.0


def test_prefill_length_gate(built):
    """Entries were captured at SEQ: a shorter prompt never replays them,
    even when the threshold passes everything — in both packages."""
    jeng, teng, corpus, _ = built
    toks = np.asarray(corpus.sample(4)[0])
    toks[:, SEQ - 4:] = 0                       # padded to the bucket
    lens = np.full(4, SEQ - 4, np.int32)
    _, _, tp = _port_prefill(teng, toks, -1e9, lengths=lens)
    _, _, jp = _jax_prefill(jeng, toks, -1e9, lengths=lens)
    assert not any(p[1].any() for p in tp)
    assert not any(p[1].any() for p in jp)
    _, _, st = teng.prefill({"tokens": corpus.sample(4)[0]},
                            threshold=-1e9)
    assert st.n_hits == st.n_layer_attempts > 0


def test_prefill_requires_causal():
    """A bidirectional model can never replay causal-prefill entries, so
    the engine refuses at build time."""
    cfg = get_reduced("bert_base").replace(n_layers=2, d_model=128,
                                           d_ff=256, n_heads=4)
    model = build_model(cfg, device="cpu")
    eng = MemoEngine(model, model.init(0),
                     MemoSpec.flat(prefill_enabled=True, embed_steps=10))
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ)
    with pytest.raises(ValueError, match="causal"):
        eng.build([{"tokens": corpus.sample(4)[0]}])


def test_capture_gates_to_prefill_batches(built):
    """With prefill memoization on, ONLY prefill batches capture: an
    APM-only capture would admit zero-K/V entries."""
    jeng, teng, _, _ = built
    for eng in (jeng, teng):
        admit0 = eng.mc.admit
        eng.mc.admit = True
        try:
            assert eng._capture_now(True, prefill=True)
            assert not eng._capture_now(True, prefill=False)
        finally:
            eng.mc.admit = admit0


def test_prefill_admission_stores_kv():
    """A prefill batch's misses are admitted with their K/V: replayed, the
    new entries hit, and their caches are the decode of the stored K/V,
    within int8 quantization of the exact caches."""
    sess, model, corpus, _ = _port_session("int8")
    eng = sess.engine
    n0 = len(eng.store)
    eng.mc.admit = True
    try:
        toks = corpus.sample(4, np.random.default_rng(99))[0]
        _, _, st = eng.prefill({"tokens": toks}, threshold=1e9)
        assert st.n_hits == 0 and st.n_admitted == 4 * len(eng.layers)
    finally:
        eng.mc.admit = False
    assert len(eng.store) == n0 + st.n_admitted
    new = np.arange(n0, len(eng.store))
    kv = eng.store.codec.decode_kv(eng.store.db.parts_at(new))
    assert np.abs(kv).max() > 0                      # not the zero fallback
    lm, cm, st2 = eng.prefill({"tokens": toks}, threshold=-1e9)
    assert st2.n_hits == st2.n_layer_attempts
    le, ce = eng.prefill_exact({"tokens": toks})
    assert float((lm - le).abs().max()) <= BOUNDS["int8"]["prefill"]
    dmax, _ = _teacher_forced_decode(eng, model, lm, cm, le, ce, 2)
    assert dmax <= BOUNDS["int8"]["decode"]
