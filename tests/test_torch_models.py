"""The port's configs, data, layers, model, embedder and optimizer
against the JAX package on the same inputs and (bridged) weights.

Tolerances: f32 activations, logits and APMs within atol 1e-5 (two f32
implementations that differ in summation order); LM logits of whole
reduced models within 1e-4 (the same, compounded over layers and a
vocab-wide head; the rwkv6 kernel path within 3e-4, see
``FORWARD_ATOL``); copied numpy code (configs, corpus) must
be EQUAL."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core import embedding as jemb
from repro.data import TemplateCorpus as JaxCorpus
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import embedding as temb
from repro_torch.core.similarity import similarity_score
from repro_torch.data import TemplateCorpus
from repro_torch.models import backbone as bb
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.optim import adamw as tadamw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
CPU = torch.device("cpu")


def _small(**kw):
    kw = dict(dict(n_classes=4, n_layers=2, d_model=128, d_ff=256,
                   n_heads=4, n_kv_heads=4), **kw)
    return (get_reduced("bert_base").replace(**kw),
            jax_get_reduced("bert_base").replace(**kw))


def test_configs_are_copies():
    """Every arch's CONFIG and reduced() equal the reference's (also
    under the reference's aliases "qwen2-1.5b", "kimi-k2-1t-a32b",
    "recurrentgemma-2b" and "whisper-medium"), and minicpm3's
    optimized() too; the whole zoo is ported, and an unknown name
    raises."""
    for arch in ("bert_base", "gpt2_small", "rwkv6_3b", "qwen2_1_5b",
                 "qwen3_8b", "deepseek_7b", "chameleon_34b", "qwen2-1.5b",
                 "minicpm3_4b", "dbrx_132b", "kimi_k2_1t_a32b",
                 "kimi-k2-1t-a32b", "recurrentgemma_2b", "whisper_medium",
                 "recurrentgemma-2b", "whisper-medium"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(get_reduced(arch)) == \
            dataclasses.asdict(jax_get_reduced(arch))
    from repro.configs.minicpm3_4b import optimized as jax_optimized
    from repro_torch.configs.minicpm3_4b import optimized
    assert dataclasses.asdict(optimized()) == \
        dataclasses.asdict(jax_optimized())
    assert get_config("qwen2_1_5b").head_dim == 128
    assert get_config("kimi_k2_1t_a32b").head_dim == 112
    assert get_config("recurrentgemma_2b").head_dim == 256
    assert get_config("whisper_medium").encoder.n_frames == 1500
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count()
    with pytest.raises(ValueError, match="not in the zoo"):
        get_config("llama_70b")


def test_corpus_draws_identical_batches():
    a = TemplateCorpus(vocab=512, seq_len=32, n_templates=6, seed=3)
    b = JaxCorpus(vocab=512, seq_len=32, n_templates=6, seed=3)
    for _ in range(3):
        (ta, la), (tb, lb) = a.sample(8), b.sample(8)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    ref = jlayers.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind)
    out = tlayers.norm_apply(tree_to_torch(p, CPU), torch.from_numpy(x),
                             kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_rope_and_mlp_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    h = rng.standard_normal((2, 7, 16)).astype(np.float32)
    for glu, act in ((True, "silu"), (False, "gelu")):
        p = jlayers.mlp_init(jax.random.PRNGKey(2), 16, 32, glu)
        ref = jlayers.mlp_apply(p, jnp.asarray(h), act, glu)
        out = tlayers.mlp_apply(tree_to_torch(p, CPU), torch.from_numpy(h),
                                act, glu)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _tree_shapes(t):
    if isinstance(t, dict):
        return {k: _tree_shapes(v) for k, v in t.items()}
    return tuple(t.shape)


@pytest.mark.parametrize("variant", ["bert", "causal_gqa"])
def test_model_logits_and_apms_match_jax(variant):
    """The whole model with the JAX weights carried across: classify
    logits, LM logits and every layer's captured APM and hidden state.
    ``causal_gqa`` also drives RoPE, the causal mask + sliding window,
    GQA, rmsnorm and the gated MLP."""
    kw = {} if variant == "bert" else dict(
        causal=True, n_kv_heads=2, norm="rmsnorm", act="silu", glu=True,
        sliding_window=9)
    if variant == "causal_gqa":
        cfg = get_reduced("bert_base").replace(
            n_classes=4, n_layers=2, d_model=128, d_ff=256, n_heads=4, **kw)
        jcfg = jax_get_reduced("bert_base").replace(
            n_classes=4, n_layers=2, d_model=128, d_ff=256, n_heads=4, **kw)
    else:
        cfg, jcfg = _small()
    jm = jax_build_model(jcfg, layer_loop="unroll")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    assert _tree_shapes(tm.init(0)) == _tree_shapes(jp)
    tp = tree_to_torch(jp, CPU)
    toks = JaxCorpus(vocab=cfg.vocab, seq_len=32).sample(4)[0]
    jl, jcaps = jm.classify(jp, {"tokens": jnp.asarray(toks)}, capture=True)
    with torch.no_grad():
        tl, tcaps = tm.classify(tp, {"tokens": toks}, capture=True)
        tlm = tm.forward(tp, {"tokens": toks})[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert sorted(tcaps) == sorted(jcaps) == [0, 1]
    for li in jcaps:
        for key in ("apm", "hidden"):
            np.testing.assert_allclose(tcaps[li][key].numpy(),
                                       np.asarray(jcaps[li][key]),
                                       atol=ATOL, err_msg=f"{li} {key}")
    jlm = jm.forward(jp, {"tokens": jnp.asarray(toks)})[0]
    np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), atol=1e-4)


def test_model_init_is_seeded_and_device_none_raises(monkeypatch):
    cfg, _ = _small()
    a = build_model(cfg, device="cpu").init(7)
    b = build_model(cfg, device="cpu").init(7)
    assert torch.equal(a["layers"]["seg0"]["l0"]["mix"]["wq"],
                       b["layers"]["seg0"]["l0"]["mix"]["wq"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)


def test_similarity_matches_vmap():
    rng = np.random.default_rng(5)
    a = rng.random((6, 2, 8, 8)).astype(np.float32)
    b = rng.random((6, 2, 8, 8)).astype(np.float32)
    from repro.core.similarity import similarity_score as jsim
    ref = jax.vmap(jsim)(jnp.asarray(a), jnp.asarray(b))
    out = similarity_score(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    one = similarity_score(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    np.testing.assert_allclose(float(one), float(ref[0]), atol=1e-6)


@pytest.mark.parametrize("seq_len", [32, 30])
def test_embed_apply_matches_jax_and_pads(seq_len):
    """Bridged embedder params: contiguous and mask-aware pooling match
    JAX, and a padded batch embeds like its unpadded run (1e-5)."""
    rng = np.random.default_rng(6)
    H = 24
    emb = jemb.Embedder.init(jax.random.PRNGKey(3), seq_len, H, dim=16,
                             pool=8)
    tp = tree_to_torch(emb.params, CPU)
    hid = rng.standard_normal((5, seq_len, H)).astype(np.float32)
    ref = jemb.embed_apply(emb.params, jnp.asarray(hid), 8, "linear")
    out = temb.embed_apply(tp, torch.from_numpy(hid), 8, "linear")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    lens = np.array([seq_len, 17, 9, 24, 1], np.int32)
    ref = jemb.embed_apply(emb.params, jnp.asarray(hid), 8, "linear",
                           lengths=jnp.asarray(lens), full_len=seq_len)
    out = temb.embed_apply(tp, torch.from_numpy(hid), 8, "linear",
                           lengths=torch.from_numpy(lens),
                           full_len=seq_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    padded = np.concatenate([hid, rng.standard_normal(
        (5, 8, H)).astype(np.float32)], 1)
    out_pad = temb.embed_apply(tp, torch.from_numpy(padded), 8, "linear",
                               lengths=torch.from_numpy(lens),
                               full_len=seq_len)
    np.testing.assert_allclose(out_pad.numpy(), out.numpy(), atol=1e-5)


def test_siamese_loss_and_adamw_match_jax():
    rng = np.random.default_rng(7)
    emb = jemb.Embedder.init(jax.random.PRNGKey(4), 16, 8, dim=8, pool=4,
                             widths=(32, 16))
    a = rng.standard_normal((6, 16, 8)).astype(np.float32)
    b = rng.standard_normal((6, 16, 8)).astype(np.float32)
    d = rng.random(6).astype(np.float32)
    loss_fn = lambda p: jemb.siamese_loss(  # noqa: E731
        p, jnp.asarray(a), jnp.asarray(b), jnp.asarray(d), 4, "linear")
    jl, jg = jax.value_and_grad(loss_fn)(emb.params)
    tp = {k: v.requires_grad_(True)
          for k, v in tree_to_torch(emb.params, CPU).items()}
    tl = temb.siamese_loss(tp, torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(d), 4, "linear")
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jnew, jstate = jadamw.adamw_update(emb.params, jg,
                                       jadamw.adamw_init(emb.params),
                                       lr=1e-2, weight_decay=0.1,
                                       grad_clip=0.5)
    tnew, tstate = tadamw.adamw_update(
        {k: v.detach() for k, v in tp.items()}, tg,
        tadamw.adamw_init(tp), lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    assert tstate["t"] == int(jstate["t"]) == 1
    for k in jnew:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   atol=ATOL, err_msg=k)


def test_train_embedder_lowers_the_loss():
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(8)
    hid = torch.from_numpy(rng.standard_normal((32, 16, 8)).astype(
        np.float32))
    apm = torch.softmax(torch.from_numpy(rng.standard_normal(
        (32, 2, 16, 16)).astype(np.float32)), -1)
    emb = temb.Embedder.init(g, 16, 8, dim=8, pool=4, widths=(32, 16))
    trained, hist = temb.train_embedder(0, emb, hid, apm, steps=40,
                                        pair_batch=16, lr=3e-3)
    assert len(hist) == 40
    assert np.mean(hist[-5:]) < np.mean(hist[:5])
    assert trained.pool == 4 and trained.params["w1"].shape == (32, 32)


def test_gqa_apply_memo_matches_jax():
    """The memo-only attention (V and APM·V only) with bridged weights."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    cfg, jcfg = _small(n_kv_heads=2)
    p = jattn.gqa_init(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 12, 128)).astype(np.float32)
    apm = rng.random((3, 4, 12, 12)).astype(np.float32)
    apm /= apm.sum(-1, keepdims=True)
    ref = jattn.gqa_apply_memo(p, jnp.asarray(x), jcfg, jnp.asarray(apm))
    out = tattn.gqa_apply_memo(tree_to_torch(p, CPU), torch.from_numpy(x),
                               cfg, torch.from_numpy(apm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# ------------------------------------------- the kernel forward (gpt2, rwkv6)

def _perturb_rwkv(tree, rng):
    """u ~ N(0, 0.1) and w0 spread over [-8, -1] in every rwkv6 layer: at
    init u = 0 and w0 = -6 everywhere, which would leave the bonus and
    the decay's range untested."""
    def walk(t):
        if "mix" in t and "u" in t["mix"]:
            m = t["mix"]
            m["u"] = (rng.standard_normal(m["u"].shape) * 0.1).astype(
                np.float32)
            m["w0"] = rng.uniform(-8.0, -1.0, m["w0"].shape).astype(
                np.float32)
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
    walk(tree)
    return tree


def _perturb_attn(tree, rng):
    """QKV biases ~ N(0, 0.1) and qk-norm scales ~ 1 + N(0, 0.1) in every
    attention layer that has them: at init the biases are 0 and the
    scales 1, which would leave both out of the check."""
    def walk(t):
        if "mix" in t:
            for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
                if key in t["mix"]:
                    x = t["mix"][key]
                    t["mix"][key] = (x + 0.1 * rng.standard_normal(
                        x.shape)).astype(np.float32)
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
    walk(tree)
    return tree


# the reduced configs of the forward checks: (arch, overrides). The zoo's
# decoders are reduced to head_dim 64 (d 256 over 4 heads), so
# "qwen2_dh128" keeps qwen2's reduced config at head_dim 128, the width
# of every full-size dense zoo decoder and of dbrx_132b, and "kimi_dh112"
# kimi_k2's at its full model's 112; minicpm3's MLA and dbrx's and
# kimi's MoE blocks run in their reduced configs; recurrentgemma's local
# attention window is cut to 16 so that it bites at S = 40, and
# whisper's batches carry frames
ZOO = {"gpt2_small": ("gpt2_small", {}), "rwkv6_3b": ("rwkv6_3b", {}),
       "qwen2_1_5b": ("qwen2_1_5b", {}), "qwen3_8b": ("qwen3_8b", {}),
       "deepseek_7b": ("deepseek_7b", {}),
       "chameleon_34b": ("chameleon_34b", {}),
       "qwen2_dh128": ("qwen2_1_5b", dict(n_heads=2, n_kv_heads=1)),
       "minicpm3_4b": ("minicpm3_4b", {}), "dbrx_132b": ("dbrx_132b", {}),
       "kimi_dh112": ("kimi_k2_1t_a32b",
                      dict(d_model=224, n_heads=2, n_kv_heads=1)),
       "recurrentgemma_2b": ("recurrentgemma_2b", dict(sliding_window=16)),
       "whisper_medium": ("whisper_medium", {})}


def _zoo_cfgs(name):
    arch, over = ZOO[name]
    return (get_reduced(arch).replace(**over),
            jax_get_reduced(arch).replace(**over))


@pytest.fixture(scope="module")
def forward_refs():
    """One reference build per config of ZOO: numpy params (rwkv6's
    recurrence and the attention biases and qk-norm scales perturbed),
    the batch (tokens, and frames for enc-dec), the reference's logits
    under each of its attn_impls and its forward's aux (the MoE router
    loss; 0 without MoE layers)."""
    out = {}
    for name in ZOO:
        _, jcfg = _zoo_cfgs(name)
        rng = np.random.default_rng(11)
        params = jax.tree.map(np.asarray, jax.jit(
            jax_build_model(jcfg).init)(jax.random.PRNGKey(1)))
        if jcfg.mixer == "rwkv6":
            params = _perturb_rwkv(params, rng)
        params = _perturb_attn(params, rng)
        toks = rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks)}
        if jcfg.encoder is not None:
            e = jcfg.encoder
            batch["frames"] = jnp.asarray(rng.standard_normal(
                (2, e.n_frames, e.d_model)).astype(np.float32))
        logits, aux = {}, {}
        for impl in ("xla", "pallas_interpret"):
            lg, _, aux[impl] = jax_build_model(
                jcfg, attn_impl=impl).forward(params, batch)
            logits[impl] = np.asarray(lg)
        if name == "gpt2_small":
            logits["window"] = np.asarray(jax_build_model(jcfg).forward(
                params, batch, window=8)[0])
        out[name] = dict(params=params, toks=toks, logits=logits,
                         batch={k: np.array(v) for k, v in batch.items()},
                         aux={k: float(v) for k, v in aux.items()})
    return out


@pytest.mark.parametrize("arch", list(ZOO))
def test_reference_tree_bridges_to_port_init(arch, forward_refs):
    """The reference's param tree crosses unchanged and has the keys and
    shapes of the port's own init: QKV biases and qk-norm scales where
    the config has them, a tied head (qwen2) or an untied one
    (chameleon's lm_head), RG-LRU blocks in a hybrid's scan segment,
    and an enc-dec's stacked encoder and decoder layers."""
    ref = forward_refs[arch]["params"]
    tree = tree_to_torch(ref, CPU)
    cfg = _zoo_cfgs(arch)[0]
    assert _tree_shapes(build_model(cfg, device="cpu").init(
        0)) == _tree_shapes(tree) == _tree_shapes(ref)
    if cfg.encoder is not None:
        assert tree["enc_layers"]["attn"]["wq"].shape[0] == \
            cfg.encoder.n_layers
        assert tree["dec_layers"]["cross"]["wq"].shape[0] == cfg.n_layers
        return
    mix = tree["layers"]["seg0"]["l0"]["mix"]
    if cfg.layer_pattern != ("mix",):
        assert "lam" in mix and "wq" in tree["layers"]["seg0"]["l2"]["mix"]
        return
    if cfg.mixer == "mla":
        assert "w_dkv" in mix and "wq" not in mix
    else:
        assert ("bq" in mix) == cfg.qkv_bias
        assert ("q_norm" in mix) == cfg.qk_norm
    assert ("lm_head" in tree) == (not cfg.tie_embeddings)
    chan = tree["layers"][f"seg{len(bb.scan_plan(cfg)) - 1}"]["l0"]["chan"]
    assert ("w_router" in chan) == (cfg.moe is not None)


# f32 logits (|logit| up to ~4) of two implementations that sum in
# different orders; rwkv6's kernel path holds the sequential recurrence
# against the reference's chunked form, so it gets the wkv bound (3e-4).
# Measured on these inputs: gpt2 1.2e-6 under both impls, rwkv6 3.7e-5
# (plain) and 3.8e-5 (kernel). The zoo's dense GQA decoders are attention
# models like gpt2 and get its bound.
FORWARD_ATOL = {(arch, impl): 1e-4 for arch in ZOO
                for impl in ("plain", "kernel")}
FORWARD_ATOL["rwkv6_3b", "kernel"] = 3e-4


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("arch", list(ZOO))
def test_forward_matches_jax(arch, impl, forward_refs):
    """Model.forward of the port under each attn_impl against the
    reference's counterpart: "plain" ↔ "xla", "kernel" ↔
    "pallas_interpret" (on CPU tensors the kernel wrappers run their
    plain versions, so "kernel" drives the wrappers' CPU path); the
    summed MoE router aux within 1e-6 (0 without MoE layers)."""
    ref = forward_refs[arch]
    model = build_model(_zoo_cfgs(arch)[0], device="cpu", attn_impl=impl)
    with torch.no_grad():
        out, _, aux = model.forward(tree_to_torch(ref["params"], CPU),
                                    ref["batch"])
    jimpl = "xla" if impl == "plain" else "pallas_interpret"
    np.testing.assert_allclose(out.numpy(), ref["logits"][jimpl],
                               rtol=0, atol=FORWARD_ATOL[arch, impl])
    np.testing.assert_allclose(float(aux), ref["aux"][jimpl], atol=1e-6)
    assert (ref["aux"][jimpl] > 0) == (model.cfg.moe is not None)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b",
                                  "kimi_dh112", "recurrentgemma_2b",
                                  "whisper_medium"])
def test_decode_matches_full(arch, forward_refs):
    """Model.prefill of all but the last token, then one decode_step,
    against the full forward's logits at those positions (the
    reference's test_decode_matches_full, on the bridged weights):
    MLA's absorbed decode over (c_kv, k_rope), the MoE block at T = B,
    the RG-LRU state carried from prefill, whisper's cached cross
    K/V."""
    ref = forward_refs[arch]
    model = build_model(_zoo_cfgs(arch)[0], device="cpu")
    params = tree_to_torch(ref["params"], CPU)
    toks = ref["toks"][:, :12]
    S = toks.shape[1]
    extra = {k: v for k, v in ref["batch"].items() if k != "tokens"}
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks, **extra})[0]
        last, caches = model.prefill(params, {"tokens": toks[:, :S - 1],
                                              **extra}, cache_len=S + 4)
        dec, _ = model.decode_step(params, toks[:, S - 1:], caches, S - 1)
    np.testing.assert_allclose(last.numpy(), full[:, S - 2].numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dec.numpy(), full[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_forward_window_matches_jax(impl, forward_refs):
    """Model.forward(window=8) on gpt2 (a config with no window of its
    own) against the reference's sliding-window forward."""
    ref = forward_refs["gpt2_small"]
    model = build_model(get_reduced("gpt2_small"), device="cpu",
                        attn_impl=impl)
    with torch.no_grad():
        out = model.forward(tree_to_torch(ref["params"], CPU),
                            {"tokens": ref["toks"]}, window=8)[0]
    np.testing.assert_allclose(out.numpy(), ref["logits"]["window"],
                               rtol=0, atol=1e-4)
    assert np.abs(out.numpy() - ref["logits"]["xla"]).max() > 1e-2


def test_attn_impl_is_checked():
    with pytest.raises(ValueError, match="attn_impl"):
        build_model(get_reduced("gpt2_small"), device="cpu",
                    attn_impl="pallas")
