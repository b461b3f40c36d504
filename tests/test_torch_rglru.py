"""The port's RG-LRU block (``models/rglru.py``) and the hybrid backbone
that holds it against the JAX package, on the same inputs and bridged
weights.

The block at reduced recurrentgemma's width (d_model 256), its biases
perturbed off their zero init: ``_conv`` with and without a carried
history, ``_rglru_scan`` from a zero and a non-zero state,
``rglru_apply`` with and without a carried state, and ``rglru_decode``
one token at a time against the full sequence. Then the hybrid plan at
five layers, (rglru, rglru, attn) once as a ``scan`` segment and two
single RG-LRU layers past it (the full model's 8 repeats and layers 24,
25 in small): the reference's tree crosses leaf for leaf into the
port's init layout, and the forward, prefill and decode agree.

Tolerances: activations within 1e-5 (f32, two implementations that sum
in different orders), whole-model logits within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import rglru as jr
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import get_reduced
from repro_torch.models import backbone as bb
from repro_torch.models import build_model
from repro_torch.models import rglru as tr
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
LOGIT_ATOL = 1e-4
CPU = torch.device("cpu")
B, S = 2, 24


def _perturb(p, rng):
    """Biases and the conv bias ~ N(0, 0.1): at init they are 0."""
    for k in ("b_a", "b_x", "conv_b"):
        p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def block():
    """Reduced recurrentgemma's config (both sides), one RG-LRU block's
    numpy params, an input sequence and a carried state."""
    jcfg = jax_reduced("recurrentgemma_2b")
    cfg = get_reduced("recurrentgemma_2b")
    rng = np.random.default_rng(3)
    p = _perturb(jax.tree.map(np.asarray, jr.rglru_init(
        jax.random.PRNGKey(0), jcfg)), rng)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((B, cfg.d_model)).astype(np.float32),
             "conv": rng.standard_normal(
                 (B, cfg.conv_width - 1, cfg.d_model)).astype(np.float32)}
    return cfg, jcfg, p, x, state


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_rglru_init_layout_and_decays(block):
    """The port's init has the reference's keys and shapes, and the same
    Λ: softplus^-1(-log λ / c) over λ in linspace(0.9, 0.999), within
    1e-4: the map's slope, 1 / (λ |log λ|) ~ 1e3 at λ = 0.999, turns
    the f32 rounding of λ (6e-8) into ~6e-5 (4.1e-5 and 1.3e-5 of the
    f64 values measured for the two packages)."""
    cfg, _, p, _, _ = block
    mine = tr.rglru_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in p.items()}
    _close(mine["lam"], p["lam"], 1e-4)


@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "state"])
def test_conv_matches_jax(block, carried):
    cfg, jcfg, p, x, state = block
    y = x @ p["w_in"]
    hist = state["conv"] if carried else None
    out, h = jr._conv(p, jnp.asarray(y), jcfg,
                      None if hist is None else jnp.asarray(hist))
    tout, th = tr._conv(tree_to_torch(p, CPU), _t(y), cfg,
                        None if hist is None else _t(hist))
    _close(tout, out)
    _close(th, h)


@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "state"])
def test_rglru_scan_matches_jax(block, carried):
    cfg, jcfg, p, x, state = block
    y = x @ p["w_in"]
    h0 = state["h"] if carried else np.zeros((B, cfg.d_model), np.float32)
    hs, hT = jr._rglru_scan(p, jnp.asarray(y), jcfg, jnp.asarray(h0))
    ths, thT = tr._rglru_scan(tree_to_torch(p, CPU), _t(y), cfg, _t(h0))
    _close(ths, hs)
    _close(thT, hT)


@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "state"])
def test_rglru_apply_matches_jax(block, carried):
    cfg, jcfg, p, x, state = block
    st = state if carried else None
    out, new = jr.rglru_apply(p, jnp.asarray(x), jcfg,
                              None if st is None else jax.tree.map(
                                  jnp.asarray, st))
    tout, tnew = tr.rglru_apply(tree_to_torch(p, CPU), _t(x), cfg,
                                None if st is None else tree_to_torch(st,
                                                                      CPU))
    _close(tout, out)
    for k in ("h", "conv"):
        _close(tnew[k], new[k])


def test_rglru_decode_steps_match_full_sequence(block):
    """``rglru_decode`` one token at a time from ``rglru_init_state``
    against ``rglru_apply`` over the whole sequence (and the reference's
    decode at the last step)."""
    cfg, jcfg, p, x, _ = block
    tp = tree_to_torch(p, CPU)
    full, fstate = tr.rglru_apply(tp, _t(x), cfg)
    st = tr.rglru_init_state(cfg, B)
    jst = jr.rglru_init_state(jcfg, B)
    for t in range(S):
        y, st = tr.rglru_decode(tp, _t(x[:, t:t + 1]), cfg, st)
        jy, jst = jr.rglru_decode(p, jnp.asarray(x[:, t:t + 1]), jcfg, jst)
        _close(y[:, 0], full[:, t].numpy())
    _close(y, jy)
    for k in ("h", "conv"):
        _close(st[k], fstate[k].numpy())
        _close(st[k], jst[k])


# ------------------------------------------------ the hybrid backbone

HYBRID = dict(n_layers=5)    # (rglru, rglru, attn) x 1 + rglru, rglru


@pytest.fixture(scope="module")
def hybrid():
    """The reference's reduced recurrentgemma at 5 layers: numpy params
    (every RG-LRU bias perturbed), tokens and its forward logits."""
    jcfg = jax_reduced("recurrentgemma_2b").replace(**HYBRID)
    rng = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(jcfg).init)(jax.random.PRNGKey(2)))

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                if "lam" in v:
                    for k in ("b_a", "b_x", "conv_b"):
                        v[k] = (0.1 * rng.standard_normal(v[k].shape)
                                ).astype(np.float32)
                walk(v)
    walk(params)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    logits = np.asarray(jax_build_model(jcfg).forward(
        params, {"tokens": jnp.asarray(toks)})[0])
    return jcfg, params, toks, logits


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_hybrid_tree_crosses_leaf_for_leaf(hybrid):
    """The plan is a scan of one (rglru, rglru, attn) unit then two single
    RG-LRU layers; the reference's tree has the port's init layout."""
    _, params, _, _ = hybrid
    cfg = get_reduced("recurrentgemma_2b").replace(**HYBRID)
    plan = bb.scan_plan(cfg)
    assert [(s.kind, s.start, s.unit, s.reps) for s in plan] == [
        ("scan", 0, ("rglru", "rglru", "attn"), 1),
        ("single", 3, ("rglru",), 1), ("single", 4, ("rglru",), 1)]
    assert _shapes(build_model(cfg, device="cpu").init(0)) == \
        _shapes(tree_to_torch(params, CPU)) == _shapes(params)
    assert [k for _, k, _ in bb.iter_layers(tree_to_torch(params, CPU),
                                            cfg)] == list(cfg.layer_kinds())


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_hybrid_forward_matches_jax(hybrid, impl):
    _, params, toks, logits = hybrid
    cfg = get_reduced("recurrentgemma_2b").replace(**HYBRID)
    model = build_model(cfg, device="cpu", attn_impl=impl)
    with torch.no_grad():
        out = model.forward(tree_to_torch(params, CPU), {"tokens": toks})[0]
    _close(out, logits, LOGIT_ATOL)


def test_hybrid_prefill_and_decode_match_jax(hybrid):
    """``Model.prefill`` of all but 4 tokens then 4 ``decode_step``s in
    both packages: logits within 1e-4 and every cache leaf (the RG-LRU
    layers' ``h`` and ``conv``, the attention K/V) within 1e-5."""
    jcfg, params, toks, logits = hybrid
    cfg = get_reduced("recurrentgemma_2b").replace(**HYBRID)
    model = build_model(cfg, device="cpu")
    jm = jax_build_model(jcfg)
    tp = tree_to_torch(params, CPU)
    s0 = S - 4
    with torch.no_grad():
        lg, caches = model.prefill(tp, {"tokens": toks[:, :s0]},
                                   cache_len=S)
    jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :s0])},
                         cache_len=S)
    _close(lg, jlg, LOGIT_ATOL)
    _close(lg, logits[:, s0 - 1], LOGIT_ATOL)
    for t in range(s0, S):
        with torch.no_grad():
            lg, caches = model.decode_step(tp, toks[:, t:t + 1], caches, t)
        jlg, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jc,
                                 t)
        _close(lg, jlg, LOGIT_ATOL)
        _close(lg, logits[:, t], LOGIT_ATOL)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), caches))
    jleaves = jax.tree.leaves(jc)
    assert [tuple(a.shape) for a in leaves] == [b.shape for b in jleaves]
    assert caches["seg1"]["l0"]["rec"]["h"].shape == (B, cfg.d_model)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)
