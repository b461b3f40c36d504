"""The port's serving engine on the zoo's MLA and MoE models against the
JAX package, on the same inputs and bridged state (the manner of
tests/test_torch_zoo.py, whose helpers serve both sides here).

Three configs, one reference engine each, built per module and carried
into the port by the bridge:
* minicpm3_4b reduced (MLA): served in kernel and bucket mode. MLA takes
  the bucketed form in kernel mode too, as in the reference, so no
  ``memo_attention`` call may happen; prefill memoization is refused
  with the reference's ``ValueError`` (MLA caches latents, not K/V).
* dbrx_132b reduced (MoE, 4 experts top-2): kernel and bucket mode and
  memoized ``prefill`` (int8 APM and K/V).
* kimi_k2_1t_a32b reduced, cut to two query heads over one KV head at
  d_model 224 (head_dim 112, the full model's width), its dense first
  layer and one MoE layer: kernel and bucket mode and memoized prefill.

Each at three thresholds (all_hit, all_miss and one mid value at least
1e-3 from every predicted sim): per-layer hit masks and matched slots
EQUAL, sims within 1e-5, logits (and prefill caches) within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch.core.engine as engine_mod
from repro_torch.bridge import engine_from_reference
from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.memo import MemoSpec
from repro_torch.models import build_model
from test_torch_zoo import _same_decisions, _serve, _threshold
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEQ = 16
BATCH = 8
ATOL = 1e-4
# name: (arch, config overrides, prefill memoization)
ARCHS = {"minicpm3": ("minicpm3_4b", {}, False),
         "dbrx": ("dbrx_132b", {}, True),
         "kimi_dh112": ("kimi_k2_1t_a32b",
                        dict(d_model=224, n_heads=2, n_kv_heads=1), True)}


def _bridged(arch, over, prefill):
    """The reference session on ``arch``'s reduced config with ``over``,
    the port engine bridged from it and the corpus."""
    from repro.configs import get_reduced as jax_reduced
    from repro.memo import MemoSession as JaxSession
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    cfg = get_reduced(arch).replace(**over)
    jm = jax_build_model(jax_reduced(arch).replace(**over),
                         layer_loop="unroll")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(29)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=8,
                            slot_fraction=0.25, seed=5)
    calib = [corpus.sample(BATCH, rng)[0]]
    js = JaxSession.build(
        jm, jp, JaxSpec.flat(threshold=0.6, mode="bucket", embed_steps=10,
                             apm_codec="int8", prefill_enabled=prefill),
        batches=[{"tokens": jnp.asarray(t)} for t in calib],
        key=jax.random.PRNGKey(1))
    teng = engine_from_reference(js.engine, build_model(cfg, device="cpu"),
                                 device="cpu")
    return js.engine, teng, corpus


@pytest.fixture(scope="module")
def engines():
    return {name: _bridged(*spec) for name, spec in ARCHS.items()}


@pytest.mark.parametrize("mode", ["kernel", "bucket"])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_mla_moe_infer_matches_reference(engines, arch, which, mode,
                                         monkeypatch):
    """``infer``'s fast path in both packages on the same state: equal
    hits and slots per layer, logits within 1e-4. minicpm3's MLA layers
    never reach ``memo_attention``."""
    jeng, teng, corpus = engines[arch]
    jeng.mc.mode = teng.mc.mode = mode
    if arch == "minicpm3":
        def refuse(*args, **kw):
            raise AssertionError("an MLA layer reached memo_attention")
        monkeypatch.setattr(engine_mod, "memo_attention", refuse)
    else:
        assert teng.cfg.head_dim == (112 if arch == "kimi_dh112" else 64)
    toks = corpus.sample(BATCH)[0]
    thr = _threshold(jeng, toks, which, prefill=False)
    jl, jp = _serve(jeng, toks, thr, jax_side=True)
    tl, tp = _serve(teng, toks, thr)
    _same_decisions(jp, tp, which)
    assert tl.shape == (BATCH, SEQ, teng.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
@pytest.mark.parametrize("arch", ["dbrx", "kimi_dh112"])
def test_moe_prefill_matches_reference(engines, arch, which):
    """Memoized ``prefill`` on the MoE configs in both packages: equal
    hits and slots, last-token logits and every cache leaf within
    1e-4."""
    jeng, teng, corpus = engines[arch]
    jeng.mc.mode = teng.mc.mode = "bucket"
    toks = corpus.sample(BATCH)[0]
    thr = _threshold(jeng, toks, which, prefill=True)
    (jl, jc), jp = _serve(jeng, toks, thr, prefill=True, jax_side=True)
    (tl, tc), tp = _serve(teng, toks, thr, prefill=True)
    _same_decisions(jp, tp, which)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tc))
    jleaves = jax.tree.leaves(jc)
    assert [a.shape for a in leaves] == [np.shape(b) for b in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


def test_mla_prefill_memoization_is_refused(engines):
    """Building an MLA engine with prefill memoization raises the
    reference's ``ValueError``; ``prefill_exact`` still serves it, its
    caches holding the latents (c_kv, k_rope)."""
    _, teng, corpus = engines["minicpm3"]
    eng = engine_mod.MemoEngine(teng.model, teng.params,
                                MemoSpec.flat(prefill_enabled=True))
    with pytest.raises(ValueError, match="serves GQA 'attn' layers only"):
        eng.build([{"tokens": corpus.sample(BATCH)[0]}])
    logits, caches = teng.prefill_exact({"tokens": corpus.sample(2)[0]})
    assert logits.shape == (2, teng.cfg.vocab)
    seg = caches["seg0"]["l0"]
    assert sorted(seg) == ["c_kv", "k_rope"]
    assert seg["c_kv"].shape[-1] == teng.cfg.mla.kv_lora_rank
