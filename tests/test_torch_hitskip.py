"""The fast path's per-quantum hit-skip against the JAX engine.

The reference sorts a bucketed layer's rows hit-first, cuts them into
``device_quanta`` quanta and picks, per quantum, ``all_hit`` (memo-only
attention), ``all_miss`` (plain attention) or ``mixed`` with a nested
``lax.cond`` on the quantum's hit count. The port takes the same branch
(``core/cond.py``: a Python ``if`` on the CPU, conditional graph nodes on
the card). Here, on the CPU:

* the bucket fast path on ``test_torch_engine.py``'s reduced bert_base
  at ``device_quanta`` 1, 2 and 4 and thresholds ±1e9 and a mid one:
  hits and slots EQUAL to the reference's, logits within LOGIT_ATOL
  (1e-4, the f32 tolerance of ``test_device_quanta_match_reference``);
* a batch chosen so that one quantum takes each branch: each quantum
  takes the branch the reference's predicate picks (evaluated with
  ``jnp`` as the reference writes it), and no attention scores are
  computed while an all-hit quantum runs; the same on a hand-made hit
  mask fed to the branch, against the every-row mixed form;
* memoized prefill on reduced gpt2_small the same way (last-token logits
  and every cache leaf within 1e-4), an all-hit quantum's caches
  bit-equal to the decode of the stored K/V;
* one MLA model (reduced minicpm3_4b, kernel mode, which takes the
  bucket form);
* the graph cache's key, which moves with a weight's address."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.engine as engine_mod
from repro_torch.bridge import engine_from_reference
from repro_torch.configs import get_reduced
from repro_torch.core import cond
from repro_torch.core.prefill import unstack_kv_rows
from repro_torch.data import TemplateCorpus
from repro_torch.models import attention as attn_mod
from repro_torch.models import build_model
from test_torch_engine import MARGIN, _compare, _serve, built  # noqa: F401
from test_torch_prefill import _jax_prefill, _port_prefill
from test_torch_select import _check_outcome, _set, _threshold
from test_torch_zoo import _same_decisions
from test_torch_zoo import _serve as _zoo_serve
from test_torch_zoo import _threshold as _zoo_threshold
from test_torch_zoo_mla_moe import _bridged
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PF_SEQ, PF_BATCH = 16, 8
PF_ATOL = 1e-4       # port vs reference: f32 logits and caches


def _reference_branch(hit, size):
    """The reference's nesting (``core/engine.py``'s ``bucketed``), on a
    quantum's hit mask, evaluated with jnp."""
    n_hit = jnp.sum(jnp.asarray(hit).astype(jnp.int32))
    if bool(n_hit == size):
        return "all_hit"
    return "all_miss" if bool(n_hit == 0) else "mixed"


class Spy:
    """Records, per call of a layer's branch bodies, the branch name, and
    fails if attention scores (``_sdpa``, ``_qkv``, ``mla_apply``) are
    computed while an all-hit body runs."""

    def __init__(self, monkeypatch, eng):
        self.taken, self.in_hit = [], False
        for name in ("_bucket_branches", "_prefill_branches"):
            real = getattr(eng, name)
            monkeypatch.setattr(eng, name, self._wrap_branches(real))
        for fn in ("_sdpa", "_qkv", "mla_apply"):
            monkeypatch.setattr(attn_mod, fn, self._guard(getattr(attn_mod,
                                                                  fn), fn))

    def _wrap_branches(self, real):
        def branches(*a, **k):
            out = []
            for name, f in zip(cond.BRANCHES, real(*a, **k)):
                def body(*ops, _f=f, _n=name):
                    self.taken.append(_n)
                    self.in_hit = _n == "all_hit"
                    try:
                        return _f(*ops)
                    finally:
                        self.in_hit = False
                out.append(body)
            return tuple(out)
        return branches

    def _guard(self, real, name):
        def guarded(*a, **k):
            assert not self.in_hit, f"an all-hit quantum called {name}"
            return real(*a, **k)
        return guarded


def _expected_branches(hits_by_layer, nq):
    """Per layer, the reference predicate on each quantum of the
    hit-first (stable) order."""
    out = []
    for h in hits_by_layer:
        hs = np.asarray(h)[np.argsort(~np.asarray(h), kind="stable")]
        qs = len(hs) // nq
        out += [_reference_branch(hs[g * qs:(g + 1) * qs], qs)
                for g in range(nq)]
    return out


# ------------------------------------------------------------ bucket path
@pytest.mark.parametrize("quanta", [1, 2, 4])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
def test_bucket_quanta_match_reference(built, quanta, which, monkeypatch):
    """The bucket fast path in both packages: equal hits and slots,
    logits within LOGIT_ATOL; each quantum took the reference's
    branch."""
    jeng, teng, queries = built
    thr = _threshold(jeng, teng, which, queries[0])
    _set(jeng, teng, mode="bucket", device_fast_path=None,
         device_quanta=quanta)
    spy = Spy(monkeypatch, teng)
    try:
        hits = _compare(jeng, teng, {"tokens": queries[0]}, thr)
    finally:
        _set(jeng, teng, device_quanta=1)
    _check_outcome(hits, which)
    by_layer = hits.reshape(len(teng.layers), -1)
    assert spy.taken == _expected_branches(by_layer, quanta)
    if which == "all_hit":
        assert set(spy.taken) == {"all_hit"}
    elif which == "all_miss":
        assert set(spy.taken) == {"all_miss"}


def _each_branch_batch(jeng, queries):
    """Rows and a threshold that give, sorted hit-first at quanta 4 of 8
    rows, one all-hit, one mixed and two all-miss quanta on every layer:
    three rows that hit at every layer (the templates) and five that miss
    at every layer (uniform random tokens), interleaved, at a threshold
    at least MARGIN from every predicted sim."""
    rng = np.random.default_rng(5)
    rand = rng.integers(0, 512, size=(8, queries[0].shape[1]),
                        dtype=queries[0].dtype)
    pool = np.concatenate([queries[0], queries[1], rand])
    _, pend = _serve(jeng, {"tokens": jnp.asarray(pool)}, 1e9)
    sims = np.stack([p[1] for p in pend])              # (L, rows)
    lo, hi = sims.min(0), sims.max(0)
    for thr in np.unique(np.round(np.sort(sims.ravel()), 6)):
        thr = float(thr) + MARGIN
        if np.abs(sims - thr).min() < MARGIN:
            continue
        hit_all = np.nonzero(lo > thr)[0]
        miss_all = np.nonzero(hi < thr)[0]
        if len(hit_all) >= 3 and len(miss_all) >= 5:
            rows = [miss_all[0], hit_all[0], miss_all[1], miss_all[2],
                    hit_all[1], miss_all[3], hit_all[2], miss_all[4]]
            return pool[rows], thr
    pytest.fail("no threshold splits the pool into 3 hits and 5 misses")


def test_each_branch_in_one_batch(built, monkeypatch):
    """One batch with a quantum of each branch: the reference's values,
    each quantum the reference's branch, no scores in an all-hit one."""
    jeng, teng, queries = built
    toks, thr = _each_branch_batch(jeng, queries)
    _set(jeng, teng, mode="bucket", device_fast_path=None, device_quanta=4)
    spy = Spy(monkeypatch, teng)
    try:
        hits = _compare(jeng, teng, {"tokens": toks}, thr)
    finally:
        _set(jeng, teng, device_quanta=1)
    want = ["all_hit", "mixed", "all_miss", "all_miss"] * len(teng.layers)
    assert _expected_branches(hits.reshape(len(teng.layers), -1), 4) == want
    assert spy.taken == want


def test_hand_made_hits_take_the_reference_branch(built, monkeypatch):
    """A hand-made hit mask through one layer's ``_run_quanta``: each
    quantum takes the reference predicate's branch, the result equals
    the every-row mixed form on the same inputs (the plain version) and
    the unsort restores the row order."""
    _, teng, queries = built
    teng.mc.device_quanta = 4
    try:
        li, kind, lp = teng._iter_layers()[0]
        x = torch.randn(8, queries[0].shape[1], teng.cfg.d_model,
                        generator=torch.Generator().manual_seed(0))
        S, H = x.shape[1], teng.cfg.n_heads
        apm = torch.softmax(torch.randn(8, H, S, S, generator=torch.Generator()
                                        .manual_seed(1)), -1)
        hit = torch.tensor([False, True, False, True, False, False, True,
                            True])
        pos = teng._positions(8, S)
        spy = Spy(monkeypatch, teng)
        branches = teng._bucket_branches(lp, kind)
        ops = (x, apm, hit, pos, None)
        (y,) = teng._run_quanta(lp, li, ("bucket",), branches, ops)
    finally:
        teng.mc.device_quanta = 1
    assert spy.taken == _expected_branches([hit.numpy()], 4) == \
        ["all_hit", "all_hit", "all_miss", "all_miss"]
    plain = branches[2](*ops)
    torch.testing.assert_close(y, plain, rtol=0, atol=1e-5)
    # one quantum of each branch: 3 hits in 8 rows at quanta 4
    hit3 = torch.tensor([False, True, False, False, True, False, True,
                         False])
    spy.taken.clear()
    teng.mc.device_quanta = 4
    try:
        (y3,) = teng._run_quanta(lp, li, ("bucket",), branches,
                                 (x, apm, hit3, pos, None))
    finally:
        teng.mc.device_quanta = 1
    assert spy.taken == ["all_hit", "mixed", "all_miss", "all_miss"]
    torch.testing.assert_close(y3, branches[2](x, apm, hit3, pos, None),
                               rtol=0, atol=1e-5)


# ------------------------------------------------------- memoized prefill
@pytest.fixture(scope="module")
def pf_built():
    """One JAX prefill engine (reduced gpt2_small, int8 APM and K/V) and
    the port engine carried across from it."""
    from repro.configs import get_reduced as jax_reduced
    from repro.memo import MemoSession as JaxSession
    from repro.memo import MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    jm = jax_build_model(jax_reduced("gpt2_small"), layer_loop="unroll")
    jp = jm.init(jax.random.PRNGKey(0))
    corpus = TemplateCorpus(vocab=512, seq_len=PF_SEQ, n_templates=8,
                            slot_fraction=0.25, seed=3)
    rng = np.random.default_rng(17)
    calib = [corpus.sample(PF_BATCH, rng)[0] for _ in range(2)]
    js = JaxSession.build(
        jm, jp, JaxSpec.flat(threshold=0.6, mode="bucket", embed_steps=40,
                             apm_codec="int8", prefill_enabled=True),
        batches=[{"tokens": jnp.asarray(t)} for t in calib],
        key=jax.random.PRNGKey(1))
    teng = engine_from_reference(
        js.engine, build_model(get_reduced("gpt2_small"), device="cpu"),
        device="cpu")
    return js.engine, teng, corpus, calib


def _pf_mid(pend):
    """A threshold inside a gap of layer 0's sims, every sim ≥ MARGIN
    away."""
    s0 = np.sort(pend[0][0])
    sims = np.concatenate([p[0] for p in pend])
    gaps = sorted(((s0[i + 1] - s0[i], (s0[i] + s0[i + 1]) / 2)
                   for i in range(len(s0) - 1)), reverse=True)
    for _, thr in gaps:
        if np.abs(sims - thr).min() >= MARGIN:
            return float(thr)
    pytest.fail(f"no threshold with a {MARGIN} margin: {s0}")


@pytest.mark.parametrize("quanta", [1, 2, 4])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
def test_prefill_quanta_match_reference(pf_built, quanta, which,
                                        monkeypatch):
    """Memoized prefill in both packages at ``device_quanta``: equal hits
    and slots, last-token logits and every cache leaf within PF_ATOL,
    each quantum the reference's branch."""
    jeng, teng, corpus, calib = pf_built
    jeng.mc.mode = teng.mc.mode = "bucket"
    toks = calib[0] if which == "all_hit" else corpus.sample(PF_BATCH)[0]
    thr = {"all_hit": -1e9, "all_miss": 1e9}.get(which)
    if thr is None:
        thr = _pf_mid(_jax_prefill(jeng, toks, 1e9)[2])
    jeng.mc.device_quanta = teng.mc.device_quanta = quanta
    spy = Spy(monkeypatch, teng)
    try:
        jl, jc, jp = _jax_prefill(jeng, toks, thr)
        tl, tc, tp = _port_prefill(teng, toks, thr)
    finally:
        jeng.mc.device_quanta = teng.mc.device_quanta = 1
    for li, ((js, jh, ji), (ts, th, ti)) in enumerate(zip(jp, tp)):
        np.testing.assert_array_equal(th, jh, err_msg=f"hits layer {li}")
        np.testing.assert_array_equal(ti, ji, err_msg=f"slots layer {li}")
        np.testing.assert_allclose(ts, js, atol=1e-5, err_msg=f"sims {li}")
    hits = [p[1] for p in tp]
    assert spy.taken == _expected_branches(hits, quanta)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=PF_ATOL)
    leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tc))
    jleaves = jax.tree.leaves(jc)
    assert [a.shape for a in leaves] == [np.shape(b) for b in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=PF_ATOL)


@pytest.mark.parametrize("quanta", [1, 4])
def test_prefill_all_hit_caches_are_the_stored_kv(pf_built, quanta):
    """A replayed calibration batch at -1e9: every quantum all-hit, each
    layer's cache bit-equal to the decode of its own stored K/V, zero
    past the prompt."""
    _, teng, _, calib = pf_built
    teng.mc.mode, teng.mc.device_quanta = "bucket", quanta
    try:
        _, cm, st = teng.prefill({"tokens": calib[0]}, threshold=-1e9)
    finally:
        teng.mc.device_quanta = 1
    assert st.n_hits == st.n_layer_attempts
    by_li = teng._split_caches(cm)
    idx = torch.arange(PF_BATCH)      # calibration batch 0: slots 0..B-1
    for li in teng.layers:
        rows = tuple(p[idx + li * PF_BATCH]
                     for p in teng.store.device_db.parts)
        kv = teng.store.codec.decode_kv_rows(rows).float()
        k, v = unstack_kv_rows(kv, teng.cfg.n_kv_heads, teng.cfg.head_dim)
        assert torch.equal(by_li[li]["k"][:, :PF_SEQ], k)
        assert torch.equal(by_li[li]["v"][:, :PF_SEQ], v)
        assert by_li[li]["k"][:, PF_SEQ:].abs().max() == 0


# ------------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def mla():
    return _bridged("minicpm3_4b", {}, False)


@pytest.mark.parametrize("quanta", [1, 4])
@pytest.mark.parametrize("which", ["all_hit", "all_miss", "mid"])
def test_mla_quanta_match_reference(mla, quanta, which, monkeypatch):
    """reduced minicpm3_4b in kernel mode (MLA takes the bucket form):
    equal decisions, logits within PF_ATOL, each quantum the reference's
    branch, and no ``memo_attention`` call."""
    jeng, teng, corpus = mla
    jeng.mc.mode = teng.mc.mode = "kernel"

    def refuse(*args, **kw):
        raise AssertionError("an MLA layer reached memo_attention")
    monkeypatch.setattr(engine_mod, "memo_attention", refuse)
    toks = corpus.sample(PF_BATCH)[0]
    thr = _zoo_threshold(jeng, toks, which, prefill=False)
    jeng.mc.device_quanta = teng.mc.device_quanta = quanta
    spy = Spy(monkeypatch, teng)
    try:
        jl, jp = _zoo_serve(jeng, toks, thr, jax_side=True)
        tl, tp = _zoo_serve(teng, toks, thr)
    finally:
        jeng.mc.device_quanta = teng.mc.device_quanta = 1
    _same_decisions(jp, tp, which)
    assert spy.taken == _expected_branches([p[1] for p in tp], quanta)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=PF_ATOL)


# ------------------------------------------------------------ graph keys
def test_site_key_moves_with_a_weight():
    """A site's key holds its weights' addresses: the same tensors give
    the same key; a weight moved to new storage (a reload, or a donated
    step's ``set_``) gives another, so a stale graph never replays; a
    change of the static spec does too."""
    w = {"wq": torch.randn(4, 2, 2), "wo": torch.randn(2, 2, 4)}
    k0 = cond.site_key((0, "bucket"), (1, (8, 16, 4)), list(w.values()))
    assert k0 == cond.site_key((0, "bucket"), (1, (8, 16, 4)),
                               list(w.values()))
    moved = dict(w, wo=w["wo"].clone())
    k1 = cond.site_key((0, "bucket"), (1, (8, 16, 4)), list(moved.values()))
    assert k1 != k0 and k1[:2] == k0[:2]
    w["wq"].set_(torch.randn(4, 2, 2))          # Tensor.set_: new storage
    assert cond.site_key((0, "bucket"), (1, (8, 16, 4)),
                         list(w.values())) != k0
    assert cond.site_key((0, "bucket"), (4, (8, 16, 4)),
                         list(moved.values())) != k1


def test_branch_predicate_and_quanta():
    """``branch_of`` nests as the reference does; ``n_quanta`` falls back
    to one quantum when the quanta do not tile the batch."""
    for n, size in ((4, 4), (0, 4), (2, 4), (1, 1), (0, 1)):
        assert cond.BRANCHES[cond.branch_of(n, size)] == \
            _reference_branch([True] * n + [False] * (size - n), size)
    assert [cond.n_quanta(q, 8) for q in (1, 2, 4, 3, 16)] == [1, 2, 4, 1, 1]
    assert cond.quantum_branches([True] * 3 + [False] * 5, 4) == [0, 2, 1, 1]


def test_run_quanta_on_cuda_needs_a_cache():
    """On the CPU the branch is a Python ``if``; a CUDA tensor without a
    graph cache and key is refused (checked on a stand-in whose device
    reads as CUDA: the refusal comes before any device work)."""
    hit = _FakeCuda(torch.zeros(4, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="GraphCache"):
        cond.run_quanta(hit, 1, (None, None, None), ())


class _FakeCuda:
    """A stand-in whose device reads as CUDA."""

    def __init__(self, t):
        self.shape = t.shape
        self.device = torch.device("cuda")
