"""The port's serving engine on the zoo's hybrid and encoder-decoder
models against the JAX package, on the same inputs and bridged state
(the manner of tests/test_torch_zoo.py, whose helpers serve both sides
here).

* recurrentgemma_2b reduced (rglru, rglru, attn): only the attention
  layer is memoized (``layers == [2]``, as
  tests/test_core_memo.py::test_engine_hybrid_recurrentgemma asserts);
  a prefill session (int8 APM and K/V) served in kernel and bucket mode
  and through memoized ``prefill``, whose caches carry the RG-LRU
  layers' ``h`` and ``conv`` state. A cut of it at head_dim 256 (two
  query heads of 256 over one KV head, the full model's width) drives
  the attention wrappers' new width (on CPU tensors, their plain
  versions).
* whisper_medium reduced: the encoder's self-attention memoized through
  ``_infer_encdec`` (the host path: ``_lookup`` per encoder layer) and
  the memo-free leg.

Each at three thresholds (all-hit, all-miss and one mid value at least
1e-3 from every predicted sim): per-layer hit masks and matched slots
EQUAL, sims within 1e-5, logits (and prefill caches) within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import engine_from_reference
from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.memo import MemoSpec
from repro_torch.models import build_model
from test_torch_zoo import MARGIN, _same_decisions, _serve, _threshold
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 16
BATCH = 8
ATOL = 1e-4
ARCHS = {"recurrentgemma": {}, "recurrentgemma_dh256": dict(d_head=256)}
ARCH = "recurrentgemma_2b"


def _bridged_hybrid(over):
    """The reference's prefill session on reduced recurrentgemma with
    ``over``, the port engine bridged from it and the corpus."""
    from repro.configs import get_reduced as jax_reduced
    from repro.memo import MemoSession as JaxSession
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    cfg = get_reduced(ARCH).replace(**over)
    jm = jax_build_model(jax_reduced(ARCH).replace(**over),
                         layer_loop="unroll")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(31)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=8,
                            slot_fraction=0.25, seed=7)
    calib = [corpus.sample(BATCH, rng)[0] for _ in range(2)]
    js = JaxSession.build(
        jm, jp, JaxSpec.flat(threshold=0.6, mode="bucket", embed_steps=10,
                             apm_codec="int8", prefill_enabled=True),
        batches=[{"tokens": jnp.asarray(t)} for t in calib],
        key=jax.random.PRNGKey(1))
    teng = engine_from_reference(js.engine, build_model(cfg, device="cpu"),
                                 device="cpu")
    return js.engine, teng, corpus


def _whisper_batch(cfg, rng, B=4, S=12):
    e = cfg.encoder
    return {"frames": rng.standard_normal(
                (B, e.n_frames, e.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _bridged_whisper():
    """A reference engine on reduced whisper (encoder memoized, two
    calibration batches of frames), the port engine bridged from it and
    a generator of fresh batches."""
    from repro.configs import get_reduced as jax_reduced
    from repro.core.engine import MemoEngine as JaxEngine
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    cfg = get_reduced("whisper_medium")
    jm = jax_build_model(jax_reduced("whisper_medium"), layer_loop="unroll")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(2))
    rng = np.random.default_rng(37)
    calib = [_whisper_batch(cfg, rng) for _ in range(2)]
    jeng = JaxEngine(jm, jp, JaxSpec.flat(threshold=0.5, embed_steps=10))
    jeng.build(jax.random.PRNGKey(3),
               [{k: jnp.asarray(v) for k, v in b.items()} for b in calib])
    teng = engine_from_reference(jeng, build_model(cfg, device="cpu"),
                                 device="cpu")
    return jeng, teng, rng


@pytest.fixture(scope="module")
def engines():
    out = {name: _bridged_hybrid(over) for name, over in ARCHS.items()}
    out["whisper"] = _bridged_whisper()
    return out


# the head_dim-256 cut at the mid threshold, where both branches run
CASES = [(arch, which) for arch in ARCHS
         for which in (("all_hit", "all_miss", "mid")
                       if arch == "recurrentgemma" else ("mid",))]


@pytest.mark.parametrize("mode", ["kernel", "bucket"])
@pytest.mark.parametrize("arch,which", CASES)
def test_hybrid_infer_matches_reference(engines, arch, which, mode):
    """``infer``'s fast path in both packages on the same state: the
    attention layer alone memoized, equal hits and slots, logits within
    1e-4; the RG-LRU layers run plain."""
    jeng, teng, corpus = engines[arch]
    assert jeng.layers == teng.layers == [2]
    assert teng.cfg.head_dim == (256 if arch.endswith("dh256") else 128)
    jeng.mc.mode = teng.mc.mode = mode
    toks = corpus.sample(BATCH)[0]
    thr = _threshold(jeng, toks, which, prefill=False)
    jl, jp = _serve(jeng, toks, thr, jax_side=True)
    tl, tp = _serve(teng, toks, thr)
    _same_decisions(jp, tp, which)
    assert tl.shape == (BATCH, SEQ, teng.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch,which", [("recurrentgemma", "all_hit"),
                                        ("recurrentgemma", "mid"),
                                        ("recurrentgemma_dh256", "mid")])
def test_hybrid_prefill_matches_reference(engines, arch, which):
    """Memoized ``prefill`` in both packages: equal hits and slots, the
    last-token logits and every cache leaf (the RG-LRU layers' ``h`` and
    ``conv``, the attention layer's K/V) within 1e-4; then
    ``prefill_exact`` likewise."""
    jeng, teng, corpus = engines[arch]
    jeng.mc.mode = teng.mc.mode = "bucket"
    toks = corpus.sample(BATCH)[0]
    thr = _threshold(jeng, toks, which, prefill=True)
    (jl, jc), jp = _serve(jeng, toks, thr, prefill=True, jax_side=True)
    (tl, tc), tp = _serve(teng, toks, thr, prefill=True)
    _same_decisions(jp, tp, which)
    l0 = tc["seg0"]["l0"]
    assert sorted(l0) == ["rec"] and sorted(l0["rec"]) == ["conv", "h"]
    assert l0["rec"]["h"].shape == (1, BATCH, teng.cfg.d_model)
    le, ce = teng.prefill_exact({"tokens": toks})
    jle, jce = jeng.prefill_exact({"tokens": jnp.asarray(toks)})
    for (a_l, a_c), (b_l, b_c) in (((tl, tc), (jl, jc)),
                                   ((le, ce), (jle, jce))):
        np.testing.assert_allclose(a_l.numpy(), np.asarray(b_l), rtol=0,
                                   atol=ATOL)
        leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), a_c))
        jleaves = jax.tree.leaves(b_c)
        assert [a.shape for a in leaves] == [np.shape(b) for b in jleaves]
        for a, b in zip(leaves, jleaves):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


def test_hybrid_prefill_gate_refuses_a_short_window(engines):
    """A local-attention window shorter than the prompt cannot replay a
    stored prefix: memoized prefill on the bridged store under a config
    whose window (8) is shorter than the prompt raises the reference's
    ValueError."""
    from repro_torch.core.engine import MemoEngine
    _, teng, corpus = engines["recurrentgemma"]
    cfg = teng.cfg.replace(sliding_window=8)
    eng = MemoEngine(build_model(cfg, device="cpu"), teng.params, teng.mc)
    eng.store, eng.embedder = teng.store, teng.embedder
    with pytest.raises(ValueError, match="sliding windows shorter"):
        eng.prefill({"tokens": corpus.sample(4)[0]})


def _encdec_serve(eng, batch, thr, jax_side=False, use_memo=True):
    """``infer`` on a whisper batch, each ``_lookup``'s hits and slots
    recorded. Returns (logits, stats, [(sims, hits, slots)] per
    layer)."""
    recs = []
    real = eng._lookup

    def lookup(*args, **kw):
        memo = real(*args, **kw)
        recs.append((np.asarray(memo.hit), np.asarray(memo.idx)))
        return memo
    eng._lookup = lookup
    try:
        if jax_side:
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, st = eng.infer(batch, threshold=thr, use_memo=use_memo)
    finally:
        del eng._lookup
    sims = np.asarray(list(st.sims), np.float32).reshape(len(recs), -1) \
        if recs else []
    return logits, st, [(s, h, i) for s, (h, i) in zip(sims, recs)]


@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid",
                                   "memo_free"])
def test_whisper_encoder_memo_matches_reference(engines, which):
    """``_infer_encdec`` in both packages on the same state: every encoder
    layer memoized (``layers`` = all of them), per-layer hits and slots
    equal, logits within 1e-4; the memo-free leg too."""
    jeng, teng, rng = engines["whisper"]
    n_enc = teng.cfg.encoder.n_layers
    assert jeng.layers == teng.layers == list(range(n_enc))
    assert not teng._use_fast_path() and teng.is_encdec
    batch = _whisper_batch(teng.cfg, rng)
    use_memo = which != "memo_free"
    thr = {"all_hit": -1e9, "all_miss": 1e9}.get(which)
    if which == "mid":
        sims = np.sort(np.concatenate(
            [p[0] for p in _encdec_serve(jeng, batch, 1e9, True)[2]]))
        gap, thr = max((sims[i + 1] - sims[i], (sims[i] + sims[i + 1]) / 2)
                       for i in range(len(sims) - 1))
        assert gap >= 2 * MARGIN
    jl, jst, jp = _encdec_serve(jeng, batch, thr, True, use_memo)
    tl, tst, tp = _encdec_serve(teng, batch, thr, use_memo=use_memo)
    assert tst.n_inputs == jst.n_inputs == batch["tokens"].shape[0]
    assert tst.n_hits == jst.n_hits
    assert tst.per_layer_hits == jst.per_layer_hits
    if use_memo:
        _same_decisions(jp, tp, which)
    else:
        assert tp == jp == [] and tst.n_layer_attempts == 0
    assert tl.shape == batch["tokens"].shape + (teng.cfg.vocab,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)


def test_encdec_refuses_prefill_memoization(engines):
    """Enc-dec hands no decode cache back from its encoder: building a
    prefill-memoizing engine raises the reference's ValueError."""
    _, teng, rng = engines["whisper"]
    from repro_torch.core.engine import MemoEngine
    eng = MemoEngine(teng.model, teng.params,
                     MemoSpec.flat(prefill_enabled=True))
    with pytest.raises(ValueError, match="decoder-only"):
        eng.build([_whisper_batch(teng.cfg, rng)])
    assert not eng._capture_now(True)
    assert torch.is_tensor(teng.params["enc_pos"])
