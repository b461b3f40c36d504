"""The port's host-synchronous serving paths, ``device_quanta > 1`` and
selective memoization against the JAX engine.

The same reduced bert_base reference as ``tests/test_torch_engine.py``
(its ``built`` fixture, built once for this module) is carried into the
port on the CPU. Both packages then serve the same batches through
``select`` mode, the host bucket and host kernel paths
(``device_fast_path=False``) and the bucket fast path at
``device_quanta`` 2 and 4. Per-layer hit masks and matched slots must be
EQUAL, predicted sims within 1e-5 and logits within atol 1e-4, at
thresholds ±1e9 and a mid threshold whose margin to every sim is at
least 1e-3. The host paths' hits and slots are read at ``_lookup``,
their sims from ``MemoStats.sims`` (kept in order below its cap).

Selective memoization: ``PerfModel`` gives equal benefits, active
layers and summaries on equal ``LayerProfile``s, ``profile`` takes equal
α from the same ``MemoStats``, and the port's profile covers every
memoized layer with positive times (timings are not compared)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.core.engine import MemoStats
from repro_torch.core.selective import LayerProfile, PerfModel
from test_torch_engine import (LOGIT_ATOL, _compare, _mid_threshold,  # noqa
                               built)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (mode, device_fast_path) of each host-synchronous path
HOST_PATHS = {"select": ("select", None), "host_bucket": ("bucket", False),
              "host_kernel": ("kernel", False)}


def _set(jeng, teng, **fields):
    for eng in (jeng, teng):
        for k, v in fields.items():
            setattr(eng.mc, k, v)


def _serve_host(eng, batch, thr):
    """One ``infer`` on the host-synchronous path; returns the logits,
    the per-layer (li, sims, hits, slots) as numpy and the stats."""
    rec = []
    lookup = eng._lookup

    def recording(lp, h, kind, thr_, st, li, **kw):
        memo = lookup(lp, h, kind, thr_, st, li, **kw)
        rec.append((li, np.asarray(memo.hit), np.asarray(memo.idx)))
        return memo
    eng._lookup = recording
    try:
        out, st = eng.infer(batch, threshold=thr)
    finally:
        del eng._lookup
    sims = np.asarray(list(st.sims)).reshape(len(rec), -1)
    return np.asarray(out), [(li, s, h, i)
                             for (li, h, i), s in zip(rec, sims)], st


def _compare_host(jeng, teng, batch, thr):
    jl, jp, _ = _serve_host(
        jeng, dict(batch, tokens=jnp.asarray(batch["tokens"])), thr)
    tl, tp, _ = _serve_host(teng, batch, thr)
    return _same_layers(jl, jp, tl, tp)


def _same_layers(jl, jp, tl, tp):
    """Equal per-layer hits and slots, sims within 1e-5, logits within
    LOGIT_ATOL; returns the hits of every layer, concatenated."""
    assert [p[0] for p in tp] == [p[0] for p in jp] == [0, 1]
    for (li, js, jh, ji), (_, ts, th, ti) in zip(jp, tp):
        np.testing.assert_array_equal(th, jh, err_msg=f"hits layer {li}")
        np.testing.assert_array_equal(ti, ji, err_msg=f"slots layer {li}")
        np.testing.assert_allclose(ts, js, atol=1e-5, err_msg=f"sims {li}")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
    return np.concatenate([p[2] for p in tp])


def _threshold(jeng, teng, which, tokens):
    """±1e9, or a mid threshold found on the reference's fast path (the
    host search's sims are the same within 1e-5, well inside the 1e-3
    margin)."""
    thr = {"all_hit": -1e9, "all_miss": 1e9}.get(which)
    if thr is None:
        _set(jeng, teng, mode="kernel", device_fast_path=None)
        thr = _mid_threshold(jeng, {"tokens": jnp.asarray(tokens)})
    return thr


def _check_outcome(hits, which):
    if which == "all_hit":
        assert hits.all()
    elif which == "all_miss":
        assert not hits.any()
    else:
        assert 0 < hits.sum() < hits.size


@pytest.mark.parametrize("path", sorted(HOST_PATHS))
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
def test_host_paths_match_reference(built, path, which):
    jeng, teng, queries = built
    thr = _threshold(jeng, teng, which, queries[0])
    mode, fast = HOST_PATHS[path]
    _set(jeng, teng, mode=mode, device_fast_path=fast)
    _check_outcome(_compare_host(jeng, teng, {"tokens": queries[0]}, thr),
                   which)


@pytest.mark.parametrize("quanta", [2, 4])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
def test_device_quanta_match_reference(built, quanta, which):
    """The bucket fast path at ``device_quanta`` > 1 against the
    reference: both sort the rows hit-first into quanta and take each
    quantum's all-hit / all-miss / mixed branch."""
    jeng, teng, queries = built
    thr = _threshold(jeng, teng, which, queries[0])
    _set(jeng, teng, mode="bucket", device_fast_path=None,
         device_quanta=quanta)
    try:
        _check_outcome(_compare(jeng, teng, {"tokens": queries[0]}, thr),
                       which)
    finally:
        _set(jeng, teng, device_quanta=1)


@pytest.mark.parametrize("path", ["select", "host_kernel"])
def test_varlen_host_paths_match_reference(built, path):
    """Padded variable-length rows on the host paths: the host leg of
    the length gate, mask-aware embedding and masked attention."""
    jeng, teng, queries = built
    mode, fast = HOST_PATHS[path]
    _set(jeng, teng, mode=mode, device_fast_path=fast)
    lengths = np.array([32, 20, 32, 9, 32, 32, 31, 1], np.int32)
    hits = _compare_host(jeng, teng, {"tokens": queries[1],
                                      "lengths": lengths}, -1e9)
    np.testing.assert_array_equal(hits.reshape(2, 8),
                                  np.broadcast_to(lengths == 32, (2, 8)))


def test_host_bucket_rejects_varlen_like_reference(built):
    jeng, teng, queries = built
    _set(jeng, teng, mode="bucket", device_fast_path=False)
    lengths = np.full(8, 32, np.int32)
    for eng, tokens in ((jeng, jnp.asarray(queries[1])),
                        (teng, queries[1])):
        with pytest.raises(ValueError, match="fixed-length"):
            eng.infer({"tokens": tokens, "lengths": lengths})


def test_perf_model_matches_reference():
    from repro.core.selective import LayerProfile as JaxProfile
    from repro.core.selective import PerfModel as JaxPerf
    rows = {0: (2e-3, 5e-4, 0.5), 1: (1e-3, 8e-4, 0.25),
            3: (4e-3, 1e-4, 0.0), 5: (3e-3, 2e-3, 1.0)}
    t = PerfModel({i: LayerProfile(*r) for i, r in rows.items()})
    j = JaxPerf({i: JaxProfile(*r) for i, r in rows.items()})
    for scale in (0.5, 1.0, 3.0):
        assert t.active_layers(scale) == j.active_layers(scale)
        for i in (0, 1, 2, 3, 5):
            assert t.benefit(i, scale) == j.benefit(i, scale)
    assert t.summary() == j.summary()
    assert t.active_layers() == [0, 5]


def test_profile_alpha_matches_reference(built):
    """``profile`` on both packages from the same ``MemoStats``: equal α
    per layer; the port's profile covers every memoized layer with
    positive times, and a dry ``infer`` feeds α when none is given."""
    from repro.core.engine import MemoStats as JaxStats
    jeng, teng, queries = built
    _set(jeng, teng, mode="kernel", device_fast_path=None)
    counts = dict(n_inputs=8, per_layer_hits={0: 3, 1: 8})
    jp = jeng.profile({"tokens": jnp.asarray(queries[0])},
                      alpha_from=JaxStats(**counts))
    tp = teng.profile({"tokens": queries[0]},
                      alpha_from=MemoStats(**counts))
    assert sorted(tp.profiles) == sorted(jp.profiles) == teng.layers
    for li in teng.layers:
        assert tp.profiles[li].alpha == jp.profiles[li].alpha
        assert tp.profiles[li].t_attn > 0 and tp.profiles[li].t_overhead > 0
    assert [p.alpha for p in tp.profiles.values()] == [3 / 8, 1.0]
    for fast in (None, False):                # device probe, host chain
        teng.mc.device_fast_path = fast
        dry = teng.profile({"tokens": queries[0]})
        assert sorted(dry.profiles) == teng.layers
        assert all(p.t_attn > 0 and p.t_overhead > 0
                   and 0.0 <= p.alpha <= 1.0 for p in dry.profiles.values())
    assert teng.perf is dry
