"""The port's serving engine on the zoo's dense GQA decoders against the
JAX package, on the same inputs and bridged state.

Two configs: qwen2_1_5b's reduced config cut to two query heads over one
KV head (head_dim 128, the width of every full-size zoo decoder; QKV
bias, a tied head) and qwen3_8b's reduced config (qk-norm, four query
heads over two KV heads). For each, one reference engine is built per
module with prefill memoization on (int8 APM and int8 K/V), its QKV
biases and qk-norm scales perturbed away from their init (0 and 1), and
carried into the port by the bridge. Both packages then serve the same
token batches through ``infer``'s fast path in kernel and bucket mode and
through memoized ``prefill``: per-layer hit masks and matched slots must
be EQUAL, predicted sims within 1e-5, logits and every cache leaf within
1e-4 (f32 layers stacked twice; two implementations that sum in
different orders). Thresholds sit away from every predicted sim: ±1e9,
and one mid value whose margin to every sim is at least 1e-3, so an ulp
of search arithmetic cannot flip a decision. The batches are fresh ones,
as in tests/test_torch_engine.py: a replayed calibration row's squared
distance to its own entry cancels to ~0 in the matmul form, and the
square root in the predicted sim turns that rounding into ~1e-4 of sim
(hits and slots still agree there). Last, decode after memoized prefill
on qwen2's reduced config at 2 and at 28 layers: the port's decode from
the int8 caches against the reference's, step by step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import engine_from_reference
from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.models import build_model
from test_torch_models import _perturb_attn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 16
BATCH = 8
MARGIN = 1e-3
ATOL = 1e-4
DECODE_STEPS = 8
VARIANTS = {"qwen2_dh128": ("qwen2_1_5b", dict(n_heads=2, n_kv_heads=1)),
            "qwen3": ("qwen3_8b", {})}


def _bridged(arch, over, n_calib=2):
    """The reference's prefill session on ``arch``'s reduced config with
    ``over`` (attention biases and qk-norm scales perturbed), the port
    engine bridged from it, the corpus and the calibration token
    batches."""
    from repro.configs import get_reduced as jax_reduced
    from repro.memo import MemoSession as JaxSession
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    cfg = get_reduced(arch).replace(**over)
    jm = jax_build_model(jax_reduced(arch).replace(**over),
                         layer_loop="unroll")
    rng = np.random.default_rng(23)
    jp = jax.tree.map(jnp.asarray, _perturb_attn(jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), rng))
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=8,
                            slot_fraction=0.25, seed=3)
    calib = [corpus.sample(BATCH, rng)[0] for _ in range(n_calib)]
    js = JaxSession.build(
        jm, jp, JaxSpec.flat(threshold=0.6, mode="bucket", embed_steps=40,
                             apm_codec="int8", prefill_enabled=True),
        batches=[{"tokens": jnp.asarray(t)} for t in calib],
        key=jax.random.PRNGKey(1))
    teng = engine_from_reference(js.engine, build_model(cfg, device="cpu"),
                                 device="cpu")
    return js.engine, teng, corpus, calib


@pytest.fixture(scope="module")
def engines():
    """Per variant: the reference engine, the port engine bridged from it
    and the corpus."""
    return {name: _bridged(arch, over)[:3]
            for name, (arch, over) in VARIANTS.items()}


def _serve(eng, toks, thr, *, prefill=False, jax_side=False):
    """prepare → run_layers → finalize → maintenance. Returns the outputs
    (logits, or (last logits, caches) under prefill) and the per-layer
    (sims, hits, slots) as numpy."""
    if jax_side:
        from repro.memo import MemoStats as Stats
        toks = jnp.asarray(toks)
    else:
        from repro_torch.core.engine import MemoStats as Stats
    prep = eng.prepare_batch({"tokens": toks}, threshold=thr,
                             prefill=prefill)
    eng.run_layers(prep)
    pend = [tuple(np.asarray(x) for x in p[1:4]) for p in prep.pend]
    out, st, payload = eng.finalize(prep, stats=Stats())
    eng.apply_maintenance(payload, stats=st)
    return out, pend


def _mid_threshold(pend):
    """A threshold inside a gap of layer 0's predicted sims with both
    outcomes present there and every layer's sims at least MARGIN away."""
    s0 = np.sort(pend[0][0])
    sims = np.concatenate([p[0] for p in pend])
    mids = sorted(((s0[i + 1] - s0[i], (s0[i] + s0[i + 1]) / 2)
                   for i in range(len(s0) - 1)), reverse=True)
    for _, thr in mids:
        if np.abs(sims - thr).min() >= MARGIN:
            return float(thr)
    pytest.fail(f"no threshold with a {MARGIN} margin: {s0}")


def _threshold(jeng, toks, which, prefill):
    thr = {"all_hit": -1e9, "all_miss": 1e9}.get(which)
    if thr is None:
        thr = _mid_threshold(_serve(jeng, toks, 1e9, prefill=prefill,
                                    jax_side=True)[1])
    return thr


def _same_decisions(jp, tp, which):
    assert len(tp) == len(jp)
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
        assert 0 < hits.sum() < hits.size


@pytest.mark.parametrize("mode", ["kernel", "bucket"])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_zoo_infer_matches_reference(engines, variant, which, mode):
    """``infer``'s fast path in both packages on the same state: equal
    hits and slots per layer, logits within 1e-4."""
    jeng, teng, corpus = engines[variant]
    jeng.mc.mode = teng.mc.mode = mode
    toks = corpus.sample(BATCH)[0]
    thr = _threshold(jeng, toks, which, prefill=False)
    jl, jp = _serve(jeng, toks, thr, jax_side=True)
    tl, tp = _serve(teng, toks, thr)
    _same_decisions(jp, tp, which)
    assert tl.shape == (BATCH, SEQ, teng.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("which", ["all_hit", "mid"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_zoo_prefill_matches_reference(engines, variant, which):
    """Memoized ``prefill`` (K/V capture at the config's KV heads) and
    ``prefill_exact`` in both packages: equal hits and slots, last-token
    logits and every cache leaf within 1e-4. Prefill takes the same
    bucketed form in kernel mode (tests/test_torch_prefill.py holds
    both), so bucket mode serves it here."""
    jeng, teng, corpus = engines[variant]
    jeng.mc.mode = teng.mc.mode = "bucket"
    toks = corpus.sample(BATCH)[0]
    thr = _threshold(jeng, toks, which, prefill=True)
    (jl, jc), jp = _serve(jeng, toks, thr, prefill=True, jax_side=True)
    (tl, tc), tp = _serve(teng, toks, thr, prefill=True)
    _same_decisions(jp, tp, which)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    cfg = teng.cfg
    for exact in (False, True):
        if exact:
            jl, jc = jeng.prefill_exact({"tokens": jnp.asarray(toks)})
            tl, tc = teng.prefill_exact({"tokens": toks})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=ATOL)
        leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tc))
        jleaves = jax.tree.leaves(jc)
        assert [a.shape for a in leaves] == [np.shape(b) for b in jleaves]
        assert leaves[0].shape[-2:] == (cfg.n_kv_heads, cfg.head_dim)
        for a, b in zip(leaves, jleaves):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_layers", [2, 28])
def test_zoo_decode_after_memo_prefill_by_depth(n_layers):
    """A replayed calibration batch through memoized ``prefill`` (every
    row hits on every layer, so each cache is its int8 K/V) and
    ``prefill_exact``, then DECODE_STEPS teacher-forced greedy decode
    steps from both cache sets, on qwen2's reduced config at 2 layers and
    at the full config's 28: the port's memoized decode logits within
    1e-4 of the reference's at every step, so the two packages' gaps
    between the memoized and the exact caches agree too. The gaps, and
    the gap over max|logit|, print with ``-s``."""
    jeng, teng, _, calib = _bridged("qwen2_1_5b", dict(n_layers=n_layers),
                                    n_calib=1)
    toks = calib[0]
    sides = {"jax": (jeng, jnp.asarray, jax.jit(jeng.model.decode_step)),
             "port": (teng, torch.from_numpy, teng.model.decode_step)}
    gaps = {}
    for side, (eng, put, decode) in sides.items():
        ml, mc, st = eng.prefill({"tokens": put(toks)}, threshold=-1e9)
        el, ec = eng.prefill_exact({"tokens": put(toks)})
        assert st.n_hits == st.n_layer_attempts == n_layers * BATCH
        gap, memo = 0.0, []
        with torch.no_grad():
            for step in range(DECODE_STEPS):
                t = put(np.asarray(el).argmax(-1)[:, None])
                ml, mc = decode(eng.params, t, mc, SEQ + step)
                el, ec = decode(eng.params, t, ec, SEQ + step)
                gap = max(gap, float(np.abs(np.asarray(ml)
                                            - np.asarray(el)).max()))
                memo.append(np.asarray(ml))
        gaps[side] = (gap, gap / float(np.abs(np.asarray(el)).max()), memo)
    print(f"\nqwen2 reduced at {n_layers} layers, int8 K/V: decode gap "
          f"memoized vs exact caches: reference {gaps['jax'][0]:.4e} "
          f"({gaps['jax'][1]:.4e} of max|logit|), port {gaps['port'][0]:.4e} "
          f"({gaps['port'][1]:.4e})")
    for a, b in zip(gaps["port"][2], gaps["jax"][2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    assert abs(gaps["port"][0] - gaps["jax"][0]) <= ATOL
