"""The port's MLA mixer (``models/attention.py``: ``mla_apply``,
``mla_apply_memo``, ``mla_prefill_cache``, ``mla_decode``) against the
JAX package on the same inputs (a numpy seed) and bridged weights, on
minicpm3's reduced config (4 heads, q_lora 64, kv_lora 32, qk nope 64 +
rope 32, v 64) with both latent norms perturbed off their init (1).

Tolerance: 1e-5 on outputs, APMs and caches (f32 layers that sum in
different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import attention as jattn
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import get_reduced
from repro_torch.models import attention as tattn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
CPU = torch.device("cpu")
B, S = 2, 10


@pytest.fixture(scope="module")
def mla():
    """Reduced minicpm3 configs (port, reference), numpy MLA params with
    perturbed latent norms, the inputs and positions."""
    cfg, jcfg = get_reduced("minicpm3_4b"), jax_get_reduced("minicpm3_4b")
    rng = np.random.default_rng(31)
    p = jax.tree.map(np.asarray, jattn.mla_init(jax.random.PRNGKey(4), jcfg))
    for key in ("q_norm", "kv_norm"):
        p[key] = (p[key] + 0.1 * rng.standard_normal(p[key].shape)).astype(
            np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return cfg, jcfg, p, x, pos, rng


def _apm(rng, H):
    a = rng.random((B, H, S, S)).astype(np.float32)
    return a / a.sum(-1, keepdims=True)


CASES = {"causal": {}, "window": dict(window=4),
         "bidir": dict(mask_kind="bidir"), "memo": {}, "return_apm": {},
         "kpad": {}}


@pytest.mark.parametrize("case", list(CASES))
def test_mla_apply_matches_reference(mla, case):
    """``mla_apply`` with and without a memo (one row hit, one miss), with
    ``return_apm``, with a key-padding mask (the second row 7 long), under
    a window and bidirectionally: outputs and APMs within 1e-5."""
    cfg, jcfg, p, x, pos, rng = mla
    kw, jkw, tkw = dict(CASES[case]), {}, {}
    if case == "memo":
        apm, hit = _apm(rng, cfg.n_heads), np.array([True, False])
        jkw["memo"] = jattn.Memo(apm=jnp.asarray(apm), hit=jnp.asarray(hit))
        tkw["memo"] = tattn.Memo(apm=torch.from_numpy(apm),
                                 hit=torch.from_numpy(hit))
    if case == "kpad":
        kp = np.arange(S)[None, :] < np.array([S, 7])[:, None]
        jkw["kpad"], tkw["kpad"] = jnp.asarray(kp), torch.from_numpy(kp)
    ret = case in ("return_apm", "kpad")
    jy, japm = jattn.mla_apply(p, jnp.asarray(x), jcfg,
                               positions=jnp.asarray(pos), return_apm=ret,
                               **kw, **jkw)
    ty, tapm = tattn.mla_apply(tree_to_torch(p, CPU), torch.from_numpy(x),
                               cfg, positions=torch.from_numpy(pos),
                               return_apm=ret, attn_impl="kernel", **kw,
                               **tkw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert (tapm is None) == (japm is None) == (not ret)
    if ret:
        assert tapm.shape == (B, cfg.n_heads, S, S)
        np.testing.assert_allclose(tapm.numpy(), np.asarray(japm),
                                   atol=ATOL)
    if case == "memo":      # the hit row is the memo-only form's output
        own = tattn.mla_apply_memo(tree_to_torch(p, CPU),
                                   torch.from_numpy(x[:1]), cfg,
                                   tkw["memo"].apm[:1])
        np.testing.assert_allclose(ty[:1].numpy(), own.numpy(), atol=ATOL)


def test_mla_apply_memo_matches_reference(mla):
    """The memo-only MLA (the latent kv expanded to V, then APM·V)."""
    cfg, jcfg, p, x, _, rng = mla
    apm = _apm(rng, cfg.n_heads)
    ref = jattn.mla_apply_memo(p, jnp.asarray(x), jcfg, jnp.asarray(apm))
    out = tattn.mla_apply_memo(tree_to_torch(p, CPU), torch.from_numpy(x),
                               cfg, torch.from_numpy(apm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_mla_prefill_cache_matches_reference(mla):
    """The decode cache from a prompt: c_kv and post-RoPE k_rope, padded
    with zeros to the cache length; and the empty cache's layout."""
    cfg, jcfg, p, x, pos, _ = mla
    ref = jattn.mla_prefill_cache(p, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                  S + 6)
    out = tattn.mla_prefill_cache(tree_to_torch(p, CPU), torch.from_numpy(x),
                                  cfg, torch.from_numpy(pos), S + 6)
    assert sorted(out) == sorted(ref) == ["c_kv", "k_rope"]
    for key in ref:
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, err_msg=key)
        assert not out[key][:, S:].any()
    empty = tattn.mla_init_cache(cfg, B, 5)
    jempty = jattn.mla_init_cache(jcfg, B, 5)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: v.shape for k, v in jempty.items()}


@pytest.mark.parametrize("window", [None, 4])
def test_mla_decode_matches_reference(mla, window):
    """The absorbed decode over a 6-slot ring, stepped from position 0 to
    9 (past the wrap at 6), with and without a recency window: every
    step's output and cache within 1e-5; the input cache is left as it
    was."""
    cfg, jcfg, p, _, _, rng = mla
    tp = tree_to_torch(p, CPU)
    jc = jattn.mla_init_cache(jcfg, B, 6)
    tc = tattn.mla_init_cache(cfg, B, 6)
    for pos in range(10):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jattn.mla_decode(p, jnp.asarray(x), jcfg, jc, pos,
                                  window=window)
        before = {k: v.clone() for k, v in tc.items()}
        ty, tc2 = tattn.mla_decode(tp, torch.from_numpy(x), cfg, tc,
                                   torch.tensor(pos), window=window)
        for k in tc:
            assert torch.equal(tc[k], before[k])
        tc = tc2
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                                   err_msg=f"pos {pos}")
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL, err_msg=f"{k} pos {pos}")
