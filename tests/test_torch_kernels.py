"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's kernels on the same numpy inputs.

The JAX side runs ``memo_attention(impl="xla")`` — and, in one tiny case,
the Pallas kernel under ``interpret=True`` — and ``nn_search``,
``flash_attention`` and ``wkv6_chunked`` under ``interpret=True``, as
tests/test_kernels.py does. Tolerances: f32 memo attention outputs
within atol 1e-5, flash attention within 2e-5 and wkv within 3e-4 (the
JAX tests' own bounds; see each constant); search indices EQUAL, squared
distances within 1e-4 relative (two f32 matmul formulations)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codec import _quantize_rows
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.memo_attention.ops import memo_attention as jax_memo
from repro.kernels.nn_search.kernel import nn_search_kernel
from repro.kernels.nn_search.ops import nn_search as jax_nn
from repro.kernels.rwkv6.ops import wkv6_chunked as jax_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.memo_attention.ops import memo_attention
from repro_torch.kernels.nn_search.ops import (TILE_ROWS, nn_search,
                                               split_ranges)
from repro_torch.kernels.nn_search.ref import (blocked_top1,
                                               nn_search_blocked_ref,
                                               nn_search_ref)
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_chunked_schedule_ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _softmax_rows(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32) * 3
    p = np.exp(x - x.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def _case(*, B, S, H, Hkv, dh, N, L, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    apm = _softmax_rows(rng, (N, H, L, L))
    hit_idx = rng.integers(0, N, B).astype(np.int32)
    hit = (np.arange(B) % 2).astype(np.int32)           # mixed hits
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    return q, k, v, apm, hit_idx, hit, lengths


def _both(q, k, v, db, hit_idx, hit, *, scales=None, lengths=None,
          causal, window=None, jax_kw=None):
    j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ref = jax_memo(j(q), j(k), j(v), j(db), j(hit_idx), j(hit),
                   db_scales=j(scales), lengths=j(lengths), causal=causal,
                   window=window, **(jax_kw or {"impl": "xla"}))
    n0 = memo_attention.launches
    out = memo_attention(t(q), t(k), t(v), t(db), t(hit_idx), t(hit),
                         db_scales=t(scales), lengths=t(lengths),
                         causal=causal, window=window)
    assert memo_attention.launches == n0     # CPU: the plain version
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("codec", ["int8", "f16"])
@pytest.mark.parametrize("varlen", [False, True])
def test_memo_attention_matches_jax(codec, varlen):
    """The serving case at a small size: mixed hits, bidirectional,
    int8 codes + f16 scales or an f16 DB, fixed or varlen."""
    q, k, v, apm, hi, hit, lengths = _case(B=6, S=32, H=4, Hkv=4, dh=16,
                                           N=9, L=32, seed=1)
    if codec == "int8":
        db, scales = _quantize_rows(apm)
    else:
        db, scales = apm.astype(np.float16), None
    ref, out = _both(q, k, v, db, hi, hit, scales=scales,
                     lengths=lengths if varlen else None, causal=False)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, 5)])
def test_memo_attention_gqa_ragged_matches_jax(causal, window):
    """GQA group 2, causal and sliding window, ragged S (19) against a
    DB stored at a longer L (24): the wrapper must slice [:S, :S]."""
    q, k, v, apm, hi, hit, lengths = _case(B=4, S=19, H=4, Hkv=2, dh=16,
                                           N=5, L=24, seed=2)
    db, scales = _quantize_rows(apm)
    ref, out = _both(q, k, v, db, hi, hit, scales=scales, lengths=lengths,
                     causal=causal, window=window)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_memo_attention_matches_pallas_interpret():
    """One tiny case against the Pallas kernel itself (interpret mode)."""
    q, k, v, apm, hi, hit, _ = _case(B=2, S=16, H=2, Hkv=1, dh=16, N=3,
                                     L=16, seed=3)
    db, scales = _quantize_rows(apm)
    ref, out = _both(q, k, v, db, hi, hit, scales=scales, causal=True,
                     jax_kw=dict(impl="pallas", interpret=True,
                                 block_q=8, block_k=8))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("codec", ["int8", "f16"])
def test_memo_attention_dh128_gqa6_matches_pallas_interpret(codec):
    """head_dim 128 (every full-size zoo decoder's) with six query heads
    per KV head (qwen2_1_5b's group), causal, ragged S against a longer
    DB: the plain version against the Pallas kernel (interpret mode)."""
    q, k, v, apm, hi, hit, lengths = _case(B=3, S=21, H=6, Hkv=1, dh=128,
                                           N=4, L=24, seed=7)
    if codec == "int8":
        db, scales = _quantize_rows(apm)
    else:
        db, scales = apm.astype(np.float16), None
    ref, out = _both(q, k, v, db, hi, hit, scales=scales, lengths=lengths,
                     causal=True, jax_kw=dict(impl="pallas", interpret=True,
                                              block_q=8, block_k=8))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("codec", ["int8", "f16"])
def test_memo_attention_dh112_gqa8_matches_pallas_interpret(codec):
    """head_dim 112 (kimi_k2's, 7168 / 64) with eight query heads per KV
    head (kimi's group), bidirectional, ragged S against a longer DB: the
    plain version against the Pallas kernel (interpret mode)."""
    q, k, v, apm, hi, hit, lengths = _case(B=3, S=21, H=8, Hkv=1, dh=112,
                                           N=4, L=24, seed=11)
    if codec == "int8":
        db, scales = _quantize_rows(apm)
    else:
        db, scales = apm.astype(np.float16), None
    ref, out = _both(q, k, v, db, hi, hit, scales=scales, lengths=lengths,
                     causal=False, jax_kw=dict(impl="pallas", interpret=True,
                                               block_q=8, block_k=8))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_memo_attention_rejects_other_devices():
    """Off the CPU the wrapper launches its kernel or raises — never the
    plain version (here: the meta device)."""
    t = torch.empty((1, 4, 1, 16), device="meta")
    db = torch.empty((1, 1, 4, 4), dtype=torch.float16, device="meta")
    z = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        memo_attention(t, t, t, db, z, z)
    with pytest.raises(ValueError):
        nn_search(torch.empty((2, 8), device="meta"),
                  torch.empty((5, 8), device="meta"))


@pytest.mark.parametrize("N,norms", [(37, True), (37, False), (64, True)])
def test_nn_search_matches_jax(N, norms):
    """N not a multiple of the block, cached norms or not, TOMBSTONE
    slack rows and planted duplicates: indices must be EQUAL (ties →
    the lowest index)."""
    rng = np.random.default_rng(4)
    B, dim = 6, 16
    db = rng.standard_normal((N, dim)).astype(np.float32)
    db[N - 8:] = 1.0e6                       # TOMBSTONE slack rows
    db[20] = db[3]                           # planted duplicates
    db[N - 9] = db[3]
    q = db[[3, 20, 5, 0, 11, 3]].copy()
    q[2:5] += 0.05 * rng.standard_normal((3, dim)).astype(np.float32)
    dn = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    rd, ri = jax_nn(jnp.asarray(q), jnp.asarray(db),
                    db_norms=jnp.asarray(dn) if norms else None,
                    block_q=4, block_n=16, interpret=True)
    n0 = nn_search.launches
    d, i = nn_search(torch.from_numpy(q), torch.from_numpy(db),
                     db_norms=torch.from_numpy(dn) if norms else None)
    assert nn_search.launches == n0
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert i[0] == 3 and i[1] == 3 and i[5] == 3
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-4,
                               atol=1e-3)


def _nn_edge_case(B, dim, N, seed):
    """A table with TOMBSTONE slack rows (the last eighth) and copies of
    row 0 at the first row of every later 64-row tile that is not slack,
    so the copies fall in different row ranges; query 0 is row 0 itself,
    the rest are rows plus noise. Norms are shifted by -50 so that most
    d2 are negative (the matmul form cancels)."""
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((N, dim)).astype(np.float32)
    n_live = N - N // 8
    db[n_live:] = 1.0e6                      # TOMBSTONE slack rows
    for r in range(TILE_ROWS, n_live, TILE_ROWS):
        db[r] = db[0]                        # planted duplicates
    pick = rng.integers(0, n_live, B)
    pick[0] = 0
    q = db[pick].copy()
    q[1:] += 0.05 * rng.standard_normal((B - 1, dim)).astype(np.float32)
    dn = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32) - 50.0
    return q, db, dn


@pytest.mark.parametrize("N", [1, TILE_ROWS - 1, TILE_ROWS + 1,
                               2 * TILE_ROWS - 1, 2 * TILE_ROWS + 1])
@pytest.mark.parametrize("dim", [1, 16, 50])
@pytest.mark.parametrize("B", [1, 33])
def test_nn_search_blocked_schedule_matches_jax(B, dim, N):
    """The kernel's schedule (``nn_search_blocked_ref``: 64-row tiles in
    row ranges, per-range (d2, idx), the ordered 64-bit key reduced by
    min) at the edges of a tile and a range, with duplicates of the
    answer in different ranges, negative d2 and TOMBSTONE slack rows,
    against the Pallas kernel in interpret mode and ``nn_search_ref``:
    indices EQUAL (ties → the lowest index), d2 within 1e-4 relative."""
    q, db, dn = _nn_edge_case(B, dim, N, seed=1000 * B + 10 * dim + N)
    rd, ri = nn_search_kernel(jnp.asarray(q), jnp.asarray(db),
                              db_norms=jnp.asarray(dn), block_q=8,
                              block_n=16, interpret=True)
    qt, dbt, dnt = (torch.from_numpy(a) for a in (q, db, dn))
    pd, pi = nn_search_ref(qt, dbt, dnt)
    n_tiles = -(-N // TILE_ROWS)
    # every range one tile, two ranges, and the wrapper's own split on a
    # 132-SM card
    for n_ranges in sorted({n_tiles, min(2, n_tiles),
                            split_ranges(B, N, 132)}):
        d, i = nn_search_blocked_ref(qt, dbt, dnt, n_ranges=n_ranges)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(i.numpy(), pi.numpy())
        assert i[0] == 0
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(d.numpy(), pd.numpy())
    if N > 2 * TILE_ROWS:
        assert (np.asarray(rd) < 0).any()    # the negative-d2 path ran


@pytest.mark.parametrize("n_ranges", [1, 2, 3])
@pytest.mark.parametrize("first,other", [(-0.0, 0.0), (0.0, -0.0)],
                         ids=["-0 first", "+0 first"])
def test_nn_search_key_breaks_signed_zero_ties_by_index(first, other,
                                                        n_ranges):
    """The cross-range key treats -0.0 and +0.0 as equal, as argmin and
    the kernel's in-block compare do, so the lowest index wins whichever
    sign it carries; negative distances order below both."""
    d2 = torch.full((3, 6), 5.0)
    d2[0, 1], d2[0, 4] = first, other        # a zero tie across ranges
    d2[1, 2], d2[1, 5] = other, first
    d2[2, 0], d2[2, 3], d2[2, 5] = first, -1e-30, -1e-30
    d, i = blocked_top1(d2, n_ranges, tile_rows=2)
    assert i.tolist() == torch.argmin(d2, -1).tolist() == [1, 2, 3]
    assert d[:2].tolist() == [0.0, 0.0]
    assert not torch.signbit(d[:2]).any()    # decoded as +0.0
    assert d[2].item() == np.float32(-1e-30)


# ------------------------------------------------------------ flash_attention

FLASH_ATOL = 2e-5    # f32 attention, online vs one-pass softmax (the JAX
#                      test's own bound for the Pallas kernel)


def _flash_case(B, S, H, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))


def _flash_both(q, k, v, *, causal, window, bq, bk):
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, block_q=bq, block_k=bk,
                    interpret=True)
    n0 = flash_attention.launches
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert flash_attention.launches == n0     # CPU: the plain version
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("S,H,Hkv,dh,bq,bk", [
    (64, 4, 2, 32, 32, 16),     # GQA
    (48, 2, 2, 64, 16, 16),
    (33, 4, 1, 16, 16, 16),     # ragged S, MQA
    (128, 8, 8, 64, 128, 128),
    (40, 6, 1, 128, 16, 16),    # head_dim 128, GQA group 6 (qwen2_1_5b)
    (40, 8, 1, 112, 16, 16),    # head_dim 112, GQA group 8 (kimi_k2)
])
def test_flash_attention_matches_jax(S, H, Hkv, dh, bq, bk):
    """The shapes of tests/test_kernels.py's flash sweep, causal, against
    the Pallas kernel in interpret mode."""
    q, k, v = _flash_case(2, S, H, Hkv, dh, seed=S)
    ref, out = _flash_both(q, k, v, causal=True, window=None, bq=bq, bk=bk)
    np.testing.assert_allclose(out, ref, rtol=0, atol=FLASH_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 8, 16])
def test_flash_attention_masks_match_jax(causal, window):
    """Causal and bidirectional, with and without a sliding window."""
    q, k, v = _flash_case(1, 64, 4, 2, 32, seed=5)
    ref, out = _flash_both(q, k, v, causal=causal, window=window, bq=32,
                           bk=16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=FLASH_ATOL)


# ------------------------------------------------------------- rwkv6 wkv

WKV_TOL = 3e-4       # the chunked (JAX) and sequential (port) forms sum
#                      in different orders: the JAX test's own bound


def _wkv_case(B, S, nh, N, decay_mean, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, nh, N)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, nh, N)) + decay_mean))
    u = rng.standard_normal((nh, N)) * 0.1
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


@pytest.mark.parametrize("decay_mean", [-6.0, -1.0])
@pytest.mark.parametrize("S,chunk", [(48, 16), (41, 16), (64, 32), (8, 8)])
def test_wkv6_matches_jax(S, chunk, decay_mean):
    """Ragged and exact chunks, u ≠ 0, slow and fast decay, against the
    chunked Pallas kernel in interpret mode."""
    args = _wkv_case(2, S, 3, 16, decay_mean, seed=S)
    ref = jax_wkv6(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    n0 = wkv6.launches
    out = wkv6(*map(torch.from_numpy, args))
    assert wkv6.launches == n0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=WKV_TOL,
                               atol=WKV_TOL)


WKV_RTOL = 2e-5     # against the sequential recurrence, relative to the
#                     output's scale (chip_smoke.WKV_RTOL, the card's bound)


def _jax_sequential(r, k, v, w, u):
    """The JAX package's sequential oracle (``kernels/rwkv6/ref.py``) in
    the model layout."""
    B, S, nh, N = r.shape
    bh = lambda t: jnp.asarray(t.transpose(0, 2, 1, 3).reshape(  # noqa: E731
        B * nh, S, N))
    ub = jnp.asarray(np.broadcast_to(u[None], (B, nh, N)).reshape(B * nh, N))
    o = np.asarray(jax_wkv6_ref(bh(r), bh(k), bh(v), bh(w), ub))
    return o.reshape(B, nh, S, N).transpose(0, 2, 1, 3)


def _hold_to_sequential(out, args):
    ref = _jax_sequential(*args)
    err = np.abs(out - ref).max()
    assert np.isfinite(out).all()
    assert err <= WKV_RTOL * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("decay_mean", [-6.0, -1.0, 2.0])
@pytest.mark.parametrize("edge", ["C-1", "C", "C+1", "2C+1", "4C"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_wkv6_schedule_matches_jax(chunk, edge, decay_mean):
    """The kernel's three-phase schedule (chunk end states from zero, the
    scan over chunks, each chunk's outputs from the state entering it),
    emulated in plain PyTorch, at S on both sides of the chunk edges.
    Against the JAX sequential oracle within 2e-5 of the output's scale
    and, where the JAX chunked kernel is defined in f32 (decay mean -6
    and -1), against it in interpret mode within WKV_TOL. At decay mean
    +2 (|log w| ~ 7 a step) the chunked form's exp(-L) overflows f32 and
    its clamp bites, while the schedule's chunk decays underflow to 0."""
    S = {"C-1": chunk - 1, "C": chunk, "C+1": chunk + 1,
         "2C+1": 2 * chunk + 1, "4C": 4 * chunk}[edge]
    args = _wkv_case(2, S, 3, 16, decay_mean, seed=10 * chunk + S)
    out = wkv6_chunked_schedule_ref(*map(torch.from_numpy, args),
                                    chunk).numpy()
    _hold_to_sequential(out, args)
    if decay_mean < 0:
        ref = jax_wkv6(*map(jnp.asarray, args), chunk=chunk, interpret=True)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=WKV_TOL,
                                   atol=WKV_TOL)


@pytest.mark.parametrize("w_kind", ["ones", "zeros"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_wkv6_schedule_extreme_decay(chunk, w_kind):
    """w == 1 (no decay: the state only grows) and a w holding exact zeros
    (the state is wiped at those steps; D_c == 0 exactly), against the
    JAX sequential oracle only: the chunked form's log clamps w = 0."""
    r, k, v, w, u = _wkv_case(2, 4 * chunk + 3, 3, 16, -1.0, seed=chunk)
    if w_kind == "ones":
        w = np.ones_like(w)
    else:
        w = np.where(np.random.default_rng(chunk).random(w.shape) < 0.1,
                     0.0, w).astype(np.float32)
    args = (r, k, v, w, u)
    out = wkv6_chunked_schedule_ref(*map(torch.from_numpy, args),
                                    chunk).numpy()
    _hold_to_sequential(out, args)


def test_wkv6_chunk_argument():
    """``chunk=`` is checked on every device; on the CPU any valid chunk
    gives the plain recurrence, and no launch is counted."""
    args = tuple(map(torch.from_numpy, _wkv_case(1, 9, 2, 16, -1.0, 0)))
    n0 = wkv6.launches
    torch.testing.assert_close(wkv6(*args, chunk=4), wkv6(*args), rtol=0,
                               atol=0)
    assert wkv6.launches == n0
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError):
            wkv6(*args, chunk=bad)


def test_flash_and_wkv6_reject_other_devices():
    """Off the CPU each wrapper launches its kernel or raises — never the
    plain version (here: the meta device)."""
    t = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention(t, t, t)
    with pytest.raises(ValueError):
        wkv6(t, t, t, t, torch.empty((2, 16), device="meta"))


# ------------------------------------------------- split TF32 (3xTF32)

def _tf32(x):
    """``cvt.rna.tf32.f32`` in plain PyTorch: round an f32 to a 10-bit
    mantissa, to nearest with ties away from zero (half an ulp of TF32
    added to the magnitude bits, the 13 low bits then cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, *, split):
    """a @ b as the attention kernels' mma.m16n8k8 steps: f32 sums over
    k in slices of 8, each slice adding a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
    (``split``, 3xTF32) or a_hi*b_hi alone (1xTF32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if split:
            acc = acc + al[..., ks] @ bh[..., ks, :]
            acc = acc + ah[..., ks] @ bl[..., ks, :]
        acc = acc + ah[..., ks] @ bh[..., ks, :]
    return acc


def _attention(q, k, v, *, causal, mm):
    """The kernels' attention on (B,H,S,dh): scores scaled by dh^-1/2,
    f32 softmax numerators, P·V, then the division by the row sum."""
    S, dh = q.shape[-2:]
    s = mm(q, k.transpose(-1, -2)) * dh ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("B,H,S,causal", [
    (2, 12, 128, False),    # bert_base's attention, B cut from 32
    (1, 2, 1024, True),     # gpt2_small-like: S=1024, causal
])
def test_split_tf32_keeps_f32_accuracy(B, H, S, causal):
    """Why the attention kernels split each f32 operand into two TF32
    values: with three TF32 products per f32 product (f32 sums) the
    output lands within the card's tolerance (chip_smoke.ATOL) of an f64
    reference; with one TF32 product it does not."""
    from chip_smoke import ATOL as CARD_ATOL
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, 64)))
               for _ in range(3))
    ref = _attention(q, k, v, causal=causal, mm=torch.matmul)    # f64
    q, k, v = q.float(), k.float(), v.float()
    err = {split: (_attention(q, k, v, causal=causal,
                              mm=lambda a, b: _mm_tf32(a, b, split=split))
                   .double() - ref).abs().max().item()
           for split in (True, False)}
    assert err[True] <= CARD_ATOL < err[False], err


def _slices(a, b, pairs):
    """sum over k in slices of 8 of sum_i a_i[..., ks] @ b_i[..., ks, :],
    each product added to one f32 accumulator in turn (a wgmma chain)."""
    acc = torch.zeros(a[0].shape[:-1] + b[0].shape[-1:],
                      dtype=torch.float32)
    for k0 in range(0, a[0].shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for i, j in pairs:
            acc = acc + a[i][..., ks] @ b[j][..., ks, :]
    return acc


def _wgmma_attention(q, k, v, *, causal, split, kt=32):
    """The wgmma tile's schedule (csrc/attention_wgmma.cuh) on (B,H,S,dh)
    f32: keys in tiles of ``kt`` (one online-softmax step each). With
    ``split`` the scores sum Q hi [K hi; K lo] as one chain and Q lo K hi
    as another, the small sums joined in f32 before the large one; past
    dh 128 each half of dh does so in its own block of the cluster and
    the two partial scores are added, rank 0's + rank 1's. Each tile's
    P·V sums p_lo v_hi, p_hi v_lo, p_hi v_hi per 8-key slice into a fresh
    accumulator that joins O in f32 (O = O alpha + acc). Without, one
    TF32 product each. Rows divide by their sums last, clamped at
    1e-30."""
    B, H, S, dh = q.shape
    qh, kh, vh = _tf32(q), _tf32(k), _tf32(v)
    ql, kl, vl = _tf32(q - qh), _tf32(k - kh), _tf32(v - vh)
    o = torch.zeros_like(q)
    m = torch.full((B, H, S, 1), -1e30)
    lsum = torch.zeros((B, H, S, 1))
    rows = torch.arange(S)[:, None]
    half = dh // 2 if dh > 128 else dh     # dh columns a block holds
    for c0 in range(0, S, kt):
        ks = slice(c0, min(c0 + kt, S))
        s = 0
        for d0 in range(0, dh, half):
            ds = slice(d0, d0 + half)
            kt_h = kh[..., ks, ds].transpose(-1, -2)
            kt_l = kl[..., ks, ds].transpose(-1, -2)
            big = _slices([qh[..., ds]], [kt_h], [(0, 0)])
            if split:
                big = (_slices([qh[..., ds]], [kt_l], [(0, 0)])
                       + _slices([ql[..., ds]], [kt_h], [(0, 0)])) + big
            s = s + big
        s = s * dh ** -0.5
        if causal:
            s = s.masked_fill(torch.arange(c0, ks.stop)[None, :] > rows,
                              -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(s <= -5e29, torch.zeros(()), torch.exp(s - m_new))
        m, lsum = m_new, lsum * alpha + p.sum(-1, keepdim=True)
        ph = _tf32(p)
        pairs = [(1, 0), (0, 1), (0, 0)] if split else [(0, 0)]
        acc = _slices([ph, _tf32(p - ph)], [vh[..., ks, :], vl[..., ks, :]],
                      pairs)
        o = o * alpha + acc
    return o / lsum.clamp_min(1e-30)


@pytest.mark.parametrize("dh", [112, 128, 256])
def test_wgmma_tile_schedule_keeps_f32_accuracy(dh):
    """The wgmma tile's accumulation schedule at S=1024, causal: 32-key
    steps, each step's P·V in a fresh accumulator joined to O in f32, the
    scores' small products summed apart (at dh 256 in each half of dh,
    the two halves' partial scores then added). With split TF32
    (three products per f32 product) the output lands within the card's
    tolerance (chip_smoke.ATOL) of an f64 reference; with one TF32
    product it does not."""
    from chip_smoke import ATOL as CARD_ATOL
    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 1024, dh)))
               for _ in range(3))
    ref = _attention(q, k, v, causal=True, mm=torch.matmul)       # f64
    q, k, v = q.float(), k.float(), v.float()
    err = {split: (_wgmma_attention(q, k, v, causal=True, split=split)
                   .double() - ref).abs().max().item()
           for split in (True, False)}
    assert err[True] <= CARD_ATOL < err[False], err
