"""The port's encoder-decoder backbone (``models/encdec.py``) and
``Model``'s enc-dec branches against the JAX package, on reduced
whisper_medium (2 + 2 layers, d_model 256, 4 heads of 64, 64 frames),
the same inputs and the bridged weights of one reference build.

``cross_apply`` (plain softmax, f32 scores), ``encode`` with APM capture
(every encoder layer's APM and attention input), ``decode_tokens`` in
"full", "prefill" and "decode" modes (decode's position clamped to the
last row of ``dec_pos``), ``init_caches``' layout, and ``Model.forward``
/ ``prefill`` / ``decode_step`` under both ``attn_impl``s.

Tolerances: activations, APMs and caches within 1e-5 (f32, two
implementations that sum in different orders), logits within 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import encdec as jed
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models import encdec as ted
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
LOGIT_ATOL = 1e-4
CPU = torch.device("cpu")
B, S = 2, 12


@pytest.fixture(scope="module")
def ref():
    """One reference build: config, numpy params, a batch (frames and
    tokens) and the reference's encoder output and logits."""
    jcfg = jax_reduced("whisper_medium")
    jm = jax_build_model(jcfg, layer_loop="unroll")
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(4)))
    rng = np.random.default_rng(5)
    e = jcfg.encoder
    batch = {"frames": rng.standard_normal(
                 (B, e.n_frames, e.d_model)).astype(np.float32),
             "tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    enc_h, apms = jed.encode(params, jb["frames"], jcfg, jm._ecfg,
                             capture=True, layer_loop="unroll")
    logits = {impl: np.asarray(jax_build_model(
        jcfg, attn_impl=impl).forward(params, jb)[0])
        for impl in ("xla", "pallas_interpret")}
    return dict(jcfg=jcfg, jm=jm, params=params, batch=batch, jb=jb,
                enc_h=np.asarray(enc_h),
                apms=jax.tree.map(np.asarray, apms), logits=logits)


def _cfg():
    return get_reduced("whisper_medium")


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def _tp(ref):
    return tree_to_torch(ref["params"], CPU)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_tree_crosses_unchanged(ref):
    """The reference's tree (encoder and decoder layers stacked on a
    leading axis by its ``vmap``) has the port's init layout."""
    model = build_model(_cfg(), device="cpu")
    assert _shapes(model.init(0)) == _shapes(_tp(ref)) == \
        _shapes(ref["params"])
    assert ref["params"]["enc_layers"]["attn"]["wq"].shape[0] == \
        _cfg().encoder.n_layers
    assert model.is_encdec and dataclasses.asdict(model._ecfg) == \
        dataclasses.asdict(ref["jm"]._ecfg)


def test_cross_apply_matches_jax(ref):
    params = ref["params"]["dec_layers"]
    lp = jax.tree.map(lambda a: a[1], params)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, _cfg().d_model)).astype(np.float32)
    kv = jed.cross_kv(lp["cross"], jnp.asarray(ref["enc_h"]))
    want = jed.cross_apply(lp["cross"], jnp.asarray(x), kv)
    tlp = tree_to_torch(lp, CPU)
    tkv = ted.cross_kv(tlp["cross"], torch.from_numpy(np.array(ref["enc_h"])))
    for k in ("ck", "cv"):
        _close(tkv[k], kv[k])
    _close(ted.cross_apply(tlp["cross"], torch.from_numpy(x), tkv), want)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_encode_with_capture_matches_jax(ref, impl):
    """``encode(capture=True)``: the encoder output, and every layer's
    APM and attention input (the memo key); under "kernel" the capture
    still takes the plain form, as in the reference."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu", attn_impl=impl)
    with torch.no_grad():
        enc_h, apms = ted.encode(_tp(ref), torch.from_numpy(
            ref["batch"]["frames"]), cfg, model._ecfg, capture=True,
            attn_impl=impl)
        plain_h, none = ted.encode(_tp(ref), torch.from_numpy(
            ref["batch"]["frames"]), cfg, model._ecfg, attn_impl=impl)
    _close(enc_h, ref["enc_h"])
    _close(plain_h, ref["enc_h"])
    assert none == {} and sorted(apms) == sorted(ref["apms"]) == [0, 1]
    for li, cap in ref["apms"].items():
        assert apms[li]["apm"].shape == (B, cfg.encoder.n_heads,
                                         cfg.encoder.n_frames,
                                         cfg.encoder.n_frames)
        _close(apms[li]["apm"], cap["apm"])
        _close(apms[li]["hidden"], cap["hidden"])


@pytest.mark.parametrize("pairs_a_chunk", [1, 3, 64])
def test_pair_similarity_chunks_match_jax(ref, monkeypatch, pairs_a_chunk):
    """``pair_similarity`` on the encoder's captured APMs (the whisper
    entries that made the calibration chunk its pairs), with chunks of
    1, 3 (a short last chunk) and 64 pairs (one chunk), against the
    reference's ``similarity_score`` of all pairs at once."""
    from repro.core.similarity import similarity_score as jax_score
    from repro_torch.core import similarity as sim

    apms = np.concatenate([cap["apm"] for _, cap in
                           sorted(ref["apms"].items())])
    rng = np.random.default_rng(6)
    ia, ib = (rng.integers(0, len(apms), 7) for _ in range(2))
    monkeypatch.setattr(sim, "PAIR_CHUNK_ELEMS",
                        pairs_a_chunk * apms[0].size)
    got = sim.pair_similarity(torch.from_numpy(apms), torch.from_numpy(ia),
                              torch.from_numpy(ib))
    assert got.shape == (7,)
    _close(got, jax_score(jnp.asarray(apms[ia]), jnp.asarray(apms[ib])))


def test_decode_tokens_modes_match_jax(ref):
    """``decode_tokens`` in "full", "prefill" (all but the last token,
    into caches of S + 4 slots) and "decode" (the last token, then one
    position past ``dec_pos``'s last row, which clamps): hidden states
    within 1e-5 and every cache leaf equal in layout and within 1e-5."""
    cfg, jcfg = _cfg(), ref["jcfg"]
    tp, params = _tp(ref), ref["params"]
    toks = ref["batch"]["tokens"]
    enc_h = ref["enc_h"]
    with torch.no_grad():
        h, none = ted.decode_tokens(tp, torch.from_numpy(toks),
                                    torch.from_numpy(enc_h), cfg)
    jh, _ = jed.decode_tokens(params, jnp.asarray(toks), jnp.asarray(enc_h),
                              jcfg)
    assert none is None
    _close(h, jh)
    caches = ted.encdec_init_caches(cfg, B, S + 4)
    jc = jed.encdec_init_caches(jcfg, B, S + 4)
    assert _shapes(caches) == _shapes(jc)
    with torch.no_grad():
        h, caches = ted.decode_tokens(tp, torch.from_numpy(toks[:, :-1]),
                                      torch.from_numpy(enc_h), cfg,
                                      mode="prefill", caches=caches)
    jh, jc = jed.decode_tokens(params, jnp.asarray(toks[:, :-1]),
                               jnp.asarray(enc_h), jcfg, mode="prefill",
                               caches=jc)
    _close(h, jh)
    for pos in (S - 1, params["dec_pos"].shape[0] + 3):
        with torch.no_grad():
            h, caches = ted.decode_tokens(
                tp, torch.from_numpy(toks[:, -1:]), None, cfg, mode="decode",
                caches=caches, pos=torch.tensor(pos))
        jh, jc = jed.decode_tokens(params, jnp.asarray(toks[:, -1:]), None,
                                   jcfg, mode="decode", caches=jc, pos=pos)
        _close(h, jh)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), caches))
    jleaves = jax.tree.leaves(jc)
    assert [a.shape for a in leaves] == [b.shape for b in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_model_forward_matches_jax(ref, impl):
    """``Model.forward`` ("plain" ↔ "xla", "kernel" ↔
    "pallas_interpret") within 1e-4, no aux, the encoder's APMs under
    capture."""
    model = build_model(_cfg(), device="cpu", attn_impl=impl)
    with torch.no_grad():
        lg, apms, aux = model.forward(_tp(ref), ref["batch"], capture=True)
    jimpl = "xla" if impl == "plain" else "pallas_interpret"
    _close(lg, ref["logits"][jimpl], LOGIT_ATOL)
    assert float(aux) == 0.0 and sorted(apms) == [0, 1]


def test_model_prefill_and_decode_match_forward(ref):
    """``Model.prefill`` of all but 3 tokens, then 3 ``decode_step``s,
    against the full forward's logits at those positions and against
    the reference's prefill and decode; ``init_caches`` in the
    reference's layout (cross K/V over every frame)."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    jm = ref["jm"]
    tp, params = _tp(ref), ref["params"]
    toks = ref["batch"]["tokens"]
    frames = ref["batch"]["frames"]
    full = ref["logits"]["xla"]
    s0 = S - 3
    with torch.no_grad():
        lg, caches = model.prefill(tp, {"tokens": toks[:, :s0],
                                        "frames": frames}, cache_len=S)
    jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :s0]),
                                  "frames": jnp.asarray(frames)},
                         cache_len=S)
    assert _shapes(caches) == _shapes(model.init_caches(B, S)) == \
        _shapes(jc)
    assert caches["kv"]["ck"].shape == (cfg.n_layers, B,
                                        cfg.encoder.n_frames, cfg.n_heads,
                                        cfg.head_dim)
    _close(lg, jlg, LOGIT_ATOL)
    _close(lg, full[:, s0 - 1], LOGIT_ATOL)
    for t in range(s0, S):
        with torch.no_grad():
            lg, caches = model.decode_step(tp, toks[:, t:t + 1], caches, t)
        jlg, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jc,
                                 t)
        _close(lg, jlg, LOGIT_ATOL)
        _close(lg, full[:, t], LOGIT_ATOL)
