"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``pytest -m gpu tests/test_torch_kernels_gpu.py``). No JAX here:
the machine with the card has none. Without a card every test skips.
Inputs come from ``chip_smoke.attention_case``, ``lowrank_case``,
``flash_case``, ``nn_case`` and ``wkv_case``, the generators the chip
smoke test uses (``lowrank_case``: the B-row f16 DB that kernel mode
decodes from lowrank factors for the batch's matched rows).
Three tests drive a small bert_base session on the card: the engine's
host-synchronous kernel mode and online admission, with chip_smoke's
checks (``compare_decisions``, ``admission_read_back``), and
``MemoServer`` with asynchronous maintenance (a held snapshot stays
unchanged while the worker delta-syncs under it). Two more drive the
big-memory tier with chip_smoke's phase-5d checks: a session saved and
loaded (format 3 mapped and read, format 2) serves with logits
bit-equal to the original, and a capacity-tier session promotes demoted
rows from disk whose next batch launches ``memo_attention`` over them.
Three cover memoized prefill: nn_search at its shapes and on a small
gpt2_small prefill session's calls (``chip_smoke.hold_nn_calls``), that
session's replay (no host sync, own entries, caches from the stored
K/V), and full-width gpt2_small prefill + decode against the plain
forward (``chip_smoke.prefill_decode_check``). Two cover the sharded
store on four shards of one card: ``ShardedDeviceIndex.search_fetch``
against the same combine over the plain search, and ``mesh_search``
against ``nn_search`` over the whole table.

Tolerances (``chip_smoke.ATOL``, ``WKV_RTOL``): attention outputs within
2e-5 absolute — both sides compute in f32 and differ only in summation
order (128-term sums of O(1) terms); wkv outputs within 2e-5 of the
output's scale (two f32 recurrences whose rounding the state carries);
search indices must be EQUAL (ties → the lowest index). The attention
kernels are held at head_dim 16, 32, 64, 112 (kimi_k2's), 128 (the
zoo's GQA decoders, qwen2_1_5b's serving shape among them) and 256
(recurrentgemma_2b's MQA local attention, at its serving and forward
shapes) and must refuse any other; at 112, 128 and 256 (the wgmma tile)
also at the edges of its 32-key tile, at 128 over a 1,024-key chain with
a window and at 256 over the forward's 2,560 keys with its 2,048 window
and with hit and miss clusters side by side. The routed MoE is held to the dense ``moe_ref`` on
the card, and the expert-parallel form on a (4, 1) and a (2, 2) mesh of
the one card to the routed form (nothing dropped) and to itself on the
CPU (rows dropped). Each wrapper refuses, with grad enabled, inputs that require
grad (its result would come back detached)."""
import pytest
import torch

from chip_smoke import (ATOL, TILE_EDGES, WG_EDGES, admission_read_back,
                        attention_case, capacity_promotion,
                        compare_decisions, drive, flash_case, lowrank_case,
                        nn_case,
                        nn_tie_ok, padded_batch, save_and_load, serve_all,
                        trace, wkv_case, wkv_cases, wkv_err)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.memo_attention.ops import memo_attention
from repro_torch.kernels.memo_attention.ref import memo_attention_ref
from repro_torch.kernels.nn_search.ops import nn_search
from repro_torch.kernels.nn_search.ref import nn_search_ref
from repro_torch.kernels.rwkv6.ops import CHUNK, wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(args, kw, **mask):
    n0 = memo_attention.launches
    out = memo_attention(*args, **mask, **kw)
    torch.cuda.synchronize()
    assert memo_attention.launches == n0 + 1
    ref = memo_attention_ref(*args, **mask, **kw)
    err = (out - ref).abs().max().item()
    print(f"memo_attention {mask} max|err|={err:.3e}")
    assert err <= ATOL


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "f16"])
@pytest.mark.parametrize("varlen", [False, True], ids=["fixed", "varlen"])
def test_memo_attention_serving_shapes(cuda, quant, varlen):
    args, kw = attention_case(torch, cuda, B=32, S=128, H=12, Hkv=12, dh=64,
                              N=3072, L=128, quant=quant, varlen=varlen,
                              seed=1)
    _check(args, kw, causal=False)


@pytest.mark.parametrize("S", [64, 127, 128])
def test_memo_attention_lowrank_row_db(cuda, S):
    """Kernel mode over the lowrank codec: the decoded matched rows as a
    B-row f16 DB (hit_idx = arange(B)), cut to S x S from L = 128."""
    args, kw = lowrank_case(torch, cuda, B=32, S=S, H=12, dh=64, L=128,
                            N=8, seed=3)
    assert args[3].dtype == torch.float16 and args[3].shape == (32, 12, S, S)
    _check(args, kw, causal=False)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, 5)])
def test_memo_attention_gqa_ragged(cuda, causal, window):
    args, kw = attention_case(torch, cuda, B=5, S=50, H=4, Hkv=2, dh=32,
                              N=9, L=64, quant=True, varlen=True, seed=2)
    _check(args, kw, causal=causal, window=window)


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "f16"])
def test_memo_attention_qwen2_serving_shape(cuda, quant):
    """qwen2_1_5b's serving shape: head_dim 128, 12 query heads over 2
    KV heads, causal, 3584 entries (phase 8b's store)."""
    args, kw = attention_case(torch, cuda, B=32, S=128, H=12, Hkv=2,
                              dh=128, N=3584, L=128, quant=quant,
                              varlen=False, seed=4)
    _check(args, kw, causal=True)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)],
                         ids=["causal", "window", "bidir"])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "f16"])
def test_memo_attention_head_dim_112(cuda, quant, group, causal, window):
    """kimi_k2's head_dim 112 at its serving length (S=128): query heads
    over 8 KV heads in groups of 1 and 8 (kimi's 64 over 8), all-hit,
    all-miss and mixed rows, int8 and f16 DBs, causal, windowed and
    bidirectional."""
    for hits in ("all", "none", "mixed"):
        args, kw = attention_case(torch, cuda, B=4, S=128, H=8 * group,
                                  Hkv=8, dh=112, N=6, L=128, quant=quant,
                                  varlen=False, seed=group, hits=hits)
        _check(args, kw, causal=causal, window=window)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)],
                         ids=["causal", "window", "bidir"])
@pytest.mark.parametrize("group", [1, 2, 10])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "f16"])
def test_memo_attention_head_dim_256(cuda, quant, group, causal, window):
    """recurrentgemma_2b's head_dim 256 at its serving length (S=128):
    query heads over one KV head in groups of 1, 2 and 10 (its 10 over
    1), all-hit, all-miss and mixed rows, int8 and f16 DBs."""
    for hits in ("all", "none", "mixed"):
        args, kw = attention_case(torch, cuda, B=4, S=128, H=group, Hkv=1,
                                  dh=256, N=6, L=128, quant=quant,
                                  varlen=window is not None, seed=group,
                                  hits=hits)
        _check(args, kw, causal=causal, window=window)


@pytest.mark.parametrize("H", [1, 10])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "f16"])
def test_memo_attention_dh256_neighbouring_clusters(cuda, quant, H):
    """dh 256 runs a row tile as a cluster of two blocks: batch rows that
    hit and rows that miss alternate, so hit clusters (no exchange) and
    miss clusters (partial scores exchanged every key tile) are
    neighbours in the launch order, at S=128 (2 row tiles) and S=200."""
    for S in (128, 200):
        args, kw = attention_case(torch, cuda, B=6, S=S, H=H, Hkv=1,
                                  dh=256, N=4, L=S, quant=quant,
                                  varlen=S == 200, seed=H + S)
        hit = args[5]
        hit.copy_(torch.tensor([1, 0, 0, 1, 0, 1], dtype=hit.dtype))
        for causal, window in ((True, None), (True, 40), (False, None)):
            _check(args, kw, causal=causal, window=window)


@pytest.mark.parametrize("hits", ["all", "none", "mixed"])
@pytest.mark.parametrize("dh", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("S", TILE_EDGES)
def test_memo_attention_tile_edges(cuda, S, dh, hits):
    """S at, below and past the 64-row tiles; all-hit, all-miss and mixed
    blocks; GQA; DB rows equal to S, a multiple of 64 (16-byte rows, the
    asynchronous copy) or shorter than S (zero past L)."""
    i, j = TILE_EDGES.index(S), dh // 32
    L = (S, -(-S // 64) * 64, S - 5)[(i + j) % 3]
    causal, window = ((True, None), (True, 70), (False, 24))[(i + 2 * j) % 3]
    args, kw = attention_case(torch, cuda, B=3, S=S, H=4, Hkv=2, dh=dh, N=5,
                              L=L, quant=(i + j) % 2 == 0, varlen=j == 1,
                              seed=S + dh, hits=hits)
    _check(args, kw, causal=causal, window=window)


@pytest.mark.parametrize("arch,over,T", [
    ("dbrx_132b", {}, 1024),
    ("kimi_k2_1t_a32b", dict(d_model=32), 96),
    ("dbrx_132b", {}, 4),                      # decode: T = B
])
def test_moe_apply_matches_moe_ref_on_card(cuda, arch, over, T):
    """The routed MoE against the dense ``moe_ref`` on CUDA tensors
    (reduced dbrx; kimi_k2's 384 experts top-8 at a narrow width), within
    1e-5, and bit-equal across two runs."""
    from repro_torch.configs import MoEConfig, get_reduced
    from repro_torch.models.moe import moe_apply, moe_init, moe_ref
    cfg = get_reduced(arch).replace(**over)
    if arch.startswith("kimi"):
        cfg = cfg.replace(moe=MoEConfig(n_experts=384, top_k=8, d_ff=16))
    gen = torch.Generator(device=cuda).manual_seed(T)
    params = moe_init(gen, cfg, device=cuda)
    x = torch.randn((T, cfg.d_model), generator=gen, device=cuda)
    y, aux = moe_apply(params, x, cfg)
    y_ref, aux_ref = moe_ref(params, x, cfg)
    err = (y - y_ref).abs().max().item()
    print(f"moe_apply {arch} T={T} max|err|={err:.3e}")
    assert err <= 1e-5 and abs(float(aux) - float(aux_ref)) <= 1e-6
    assert torch.equal(y, moe_apply(params, x, cfg)[0])


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("T", [1024, 4])       # the chunked body, decode's
def test_moe_apply_ep_on_a_mesh_of_one_card(cuda, shape, T):
    """The expert-parallel form on a mesh of one card (reduced dbrx): at
    a capacity factor of ep (nothing drops) it is the routed form's
    function within 1e-5; at the config's factor (rows drop) it is the
    same function run on the CPU over a CPU mesh, within 1e-5 and aux
    within 1e-6."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import moe_apply, moe_init
    cfg = get_reduced("dbrx_132b")
    gen = torch.Generator(device=cuda).manual_seed(T + shape[0])
    params = moe_init(gen, cfg, device=cuda)
    x = torch.randn((T, cfg.d_model), generator=gen, device=cuda)
    mesh = make_host_mesh(*shape, device="cuda")
    wide = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(shape[0])))
    y, _ = moe_apply(params, x, wide, mesh=mesh)
    err = (y - moe_apply(params, x, wide)[0]).abs().max().item()
    y, aux = moe_apply(params, x, cfg, mesh=mesh)
    y_h, aux_h = moe_apply({k: v.cpu() for k, v in params.items()},
                           x.cpu(), cfg,
                           mesh=make_host_mesh(*shape, device="cpu"))
    err_h = (y.cpu() - y_h).abs().max().item()
    print(f"moe_apply_ep {shape} T={T}: vs routed {err:.3e}, card vs CPU "
          f"{err_h:.3e}")
    assert err <= 1e-5 and err_h <= 1e-5
    assert abs(float(aux) - float(aux_h)) <= 1e-6


# (B, dim, N, norms, shift): query tiles of 1, 31, 33 and 128 rows,
# widths 1, 50 and 128, N at 1 and at the edges of a 64-row tile (and of
# a row range: below 264 * 64 rows every tile is a range); bert_base's
# serving shape; up to a million rows, where a block walks ~60 tiles;
# norms shifted by -shift make most d2 negative
NN_CASES = ([(B, dim, N, (B + dim + N) % 2 == 0, 0.0)
             for B in (1, 31, 33, 128) for dim in (1, 50, 128)
             for N in (1, 63, 65, 6143)]
            + [(32, 128, 3072, True, 0.0), (32, 128, 3001, True, 0.0),
               (32, 128, 3001, False, 0.0), (33, 50, 16897, True, 50.0),
               (128, 128, 65537, False, 50.0), (31, 1, 1 << 20, True, 0.0),
               (32, 128, 1 << 20, True, 0.0),
               (128, 128, (1 << 20) - 1, True, 50.0)])


@pytest.mark.parametrize("B,dim,N,norms,shift", NN_CASES)
def test_nn_search_planted_duplicates(cuda, B, dim, N, norms, shift):
    """Copies of the answer row in different row ranges, TOMBSTONE slack
    rows, negative d2: indices EQUAL to the plain version's, d2 within
    1e-3 of max|d2|, one launch per call; queries 0 and B-1, copies of
    the answer row, pick its lowest copy (at dim 1: no later copy wins,
    ``nn_tie_ok``)."""
    q, db, dn, p = nn_case(torch, cuda, B=B, dim=dim, N=N, seed=N + dim,
                           norms=norms, shift=shift)
    n0 = nn_search.launches
    d, i = nn_search(q, db, db_norms=dn)
    assert nn_search.launches == n0 + 1
    rd, ri = nn_search_ref(q, db, dn)
    assert torch.equal(i, ri)
    assert nn_tie_ok(db, i, p)
    err = (d - rd).abs().max().item()
    print(f"nn_search B={B} dim={dim} N={N} norms={norms} max|d2 err|="
          f"{err:.3e}")
    assert err <= 1e-3 * max(1.0, rd.abs().max().item())


def test_nn_search_signed_zero_norms_tie(cuda):
    """A table of zeros with norms +-0.0: every d2 is 0 and index 0 must
    win, across every row range."""
    zero = torch.zeros((6145, 16), device=cuda)
    norms = torch.zeros(6145, device=cuda)
    norms[::2] = -0.0
    d, i = nn_search(zero[:33], zero, db_norms=norms)
    assert (i == 0).all() and (d == 0).all()


def test_nn_search_workspace_resets(cuda):
    """Back-to-back calls with alternating B, queued with no sync between
    them, return what each returns alone: the last block of each call
    resets the keys and tickets it used, whatever the next call's B (the
    workspace grows to 128 queries by the second call). Each call
    takes other queries and norms raised by 10 more than the call before,
    so a key left over from an earlier call would win the atomicMin with
    a smaller d2 and another row; after the queue the workspace is back
    to all-ones keys and zero tickets."""
    from repro_torch.kernels.nn_search.ops import _WORKSPACE
    q, db, dn, _ = nn_case(torch, cuda, B=128, dim=128, N=6144, seed=9)
    g = torch.Generator().manual_seed(9)
    sizes = (1, 128, 33, 128, 1, 33)
    calls = [(q[torch.randperm(128, generator=g)[:b].to(cuda)],
              dn + 10.0 * k) for k, b in enumerate(sizes)]
    outs = [nn_search(qk, db, db_norms=dk) for qk, dk in calls]
    torch.cuda.synchronize()
    keys, tickets = _WORKSPACE[(cuda.index or 0,
                                torch.cuda.current_stream().cuda_stream)]
    assert keys.numel() >= 128
    assert (keys == -1).all() and (tickets == 0).all()
    for (qk, dk), (d, i) in zip(calls, outs):
        ad, ai = nn_search(qk, db, db_norms=dk)
        rd, ri = nn_search_ref(qk, db, dk)
        assert torch.equal(i, ri) and torch.equal(i, ai)
        assert torch.equal(d, ad)
        tol = 1e-3 * max(1.0, rd.abs().max().item())
        assert (d - rd).abs().max().item() <= tol


def test_nn_search_one_kernel_per_call(cuda):
    """The profiler sees exactly one device kernel per call: no memset,
    no second reduction launch."""
    q, db, dn, _ = nn_case(torch, cuda, B=32, dim=128, N=6144, seed=10)
    _, rows = trace(torch, lambda: nn_search(q, db, db_norms=dn), reps=5)
    assert sum(count for _, count, _ in rows) == 5
    assert all("nn_search_kernel" in name for _, _, name in rows)


@pytest.mark.parametrize("B,S,H,Hkv,dh,causal,window,strided", [
    (8, 1024, 12, 12, 64, True, None, False),   # gpt2_small's shape
    (2, 33, 4, 2, 16, True, 8, False),          # ragged, GQA, window
    (2, 1000, 4, 2, 32, False, 16, False),      # bidirectional window
    (3, 100, 6, 3, 64, True, None, True),       # read by strides
    (32, 128, 12, 2, 128, True, None, False),   # qwen2_1_5b serving
    (2, 1024, 32, 8, 128, True, None, False),   # qwen3_8b's forward
    (2, 1024, 64, 8, 112, True, None, False),   # kimi_k2's forward
    (2, 200, 8, 8, 112, False, 24, False),      # dh 112, group 1
    (1, 2560, 10, 1, 256, True, 2048, False),   # recurrentgemma_2b's
    (32, 128, 10, 1, 256, True, 2048, False),   # its serving shape
    (2, 200, 4, 2, 256, False, 24, False),      # dh 256, group 2
])
def test_flash_attention_against_plain(cuda, B, S, H, Hkv, dh, causal,
                                       window, strided):
    q, k, v = flash_case(torch, cuda, B=B, S=S, H=H, Hkv=Hkv, dh=dh,
                         seed=S, strided=strided)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    err = (out - flash_attention_ref(q, k, v, causal=causal,
                                     window=window)).abs().max().item()
    print(f"flash_attention S={S} max|err|={err:.3e}")
    assert err <= ATOL


@pytest.mark.parametrize("causal,window", [(True, None), (True, 70),
                                           (False, 24)])
@pytest.mark.parametrize("dh", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("S", TILE_EDGES)
def test_flash_attention_tile_edges(cuda, S, dh, causal, window):
    """S at, below and past the 64-row tiles, GQA, every head_dim."""
    q, k, v = flash_case(torch, cuda, B=2, S=S, H=4, Hkv=2, dh=dh,
                         seed=S + dh)
    out = flash_attention(q, k, v, causal=causal, window=window)
    err = (out - flash_attention_ref(q, k, v, causal=causal,
                                     window=window)).abs().max().item()
    print(f"flash_attention S={S} dh={dh} max|err|={err:.3e}")
    assert err <= ATOL


@pytest.mark.parametrize("hits", ["all", "none", "mixed"])
@pytest.mark.parametrize("dh", [112, 128])
@pytest.mark.parametrize("S", WG_EDGES)
def test_attention_wgmma_key_tile_edges(cuda, S, dh, hits):
    """The wgmma tile (head_dim 112 and 128; dh 112's last 128-byte atom
    half used) at the edges of its 32-key tile, both kernels, every mask,
    GQA, int8 and f16 DBs, ragged lengths."""
    i = WG_EDGES.index(S)
    for causal, window in ((True, None), (True, 20), (False, 24)):
        q, k, v = flash_case(torch, cuda, B=2, S=S, H=4, Hkv=2, dh=dh,
                             seed=S + dh + i)
        out = flash_attention(q, k, v, causal=causal, window=window)
        err = (out - flash_attention_ref(q, k, v, causal=causal,
                                         window=window)).abs().max().item()
        print(f"flash_attention S={S} dh={dh} max|err|={err:.3e}")
        assert err <= ATOL
        args, kw = attention_case(torch, cuda, B=3, S=S, H=4, Hkv=2, dh=dh,
                                  N=3, L=S, quant=(i + dh) % 2 == 0,
                                  varlen=window is not None,
                                  seed=S + dh + 1, hits=hits)
        _check(args, kw, causal=causal, window=window)


@pytest.mark.parametrize("hits", ["all", "none", "mixed"])
@pytest.mark.parametrize("group", [1, 2, 10])
@pytest.mark.parametrize("S", WG_EDGES)
def test_attention_wgmma_dh256_key_tile_edges(cuda, S, group, hits):
    """The wgmma tile at dh 256 (a cluster of two blocks a row tile, each
    holding half of dh and exchanging partial scores) at the edges of its
    32-key tile: both kernels, every mask, query heads per KV head 1, 2
    and 10 (recurrentgemma_2b's 10 over 1), int8 and f16 DBs, ragged
    lengths under the window."""
    i = WG_EDGES.index(S)
    Hkv = 1 if group == 10 else 2
    for causal, window in ((True, None), (True, 20), (False, 24)):
        q, k, v = flash_case(torch, cuda, B=2, S=S, H=group * Hkv, Hkv=Hkv,
                             dh=256, seed=S + group + i)
        out = flash_attention(q, k, v, causal=causal, window=window)
        err = (out - flash_attention_ref(q, k, v, causal=causal,
                                         window=window)).abs().max().item()
        print(f"flash_attention S={S} dh=256 G={group} max|err|={err:.3e}")
        assert err <= ATOL
        for quant in (True, False):
            args, kw = attention_case(torch, cuda, B=3, S=S, H=group * Hkv,
                                      Hkv=Hkv, dh=256, N=3, L=S,
                                      quant=quant, varlen=window is not None,
                                      seed=S + group + 1, hits=hits)
            _check(args, kw, causal=causal, window=window)


def test_attention_wgmma_dh256_forward_window(cuda):
    """memo_attention at dh 256 over recurrentgemma_2b's forward length
    and window (S=2560, causal, window 2048): 64 key tiles a row tile,
    each one's partial scores exchanged and its P·V summed in a fresh
    accumulator joined to O in f32. (flash_attention at this shape is
    test_flash_attention_against_plain's.)"""
    args, kw = attention_case(torch, cuda, B=2, S=2560, H=2, Hkv=1,
                              dh=256, N=2, L=2560, quant=True,
                              varlen=False, seed=256, hits="mixed")
    _check(args, kw, causal=True, window=2048)


@pytest.mark.parametrize("kernel", ["flash", "memo"])
def test_attention_wgmma_long_chain(cuda, kernel):
    """dh 128 at S=1024, causal with window 70: 32 key tiles a row tile,
    each one's P·V summed in a fresh accumulator joined to O in f32 (one
    long chain of tensor-core sums would drift past the tolerance)."""
    if kernel == "flash":
        q, k, v = flash_case(torch, cuda, B=2, S=1024, H=8, Hkv=2, dh=128,
                             seed=70)
        out = flash_attention(q, k, v, causal=True, window=70)
        err = (out - flash_attention_ref(q, k, v, causal=True,
                                         window=70)).abs().max().item()
        print(f"flash_attention S=1024 window 70 max|err|={err:.3e}")
        assert err <= ATOL
    else:
        args, kw = attention_case(torch, cuda, B=4, S=1024, H=4, Hkv=2,
                                  dh=128, N=2, L=1024, quant=True,
                                  varlen=False, seed=70, hits="mixed")
        _check(args, kw, causal=True, window=70)


@pytest.mark.parametrize("dh", [8, 48, 96, 192])
def test_attention_kernels_refuse_other_head_dims(cuda, dh):
    """A CUDA tensor at a head_dim the kernels were not built for raises;
    nothing falls back to the plain version."""
    q, k, v = flash_case(torch, cuda, B=1, S=16, H=2, Hkv=1, dh=dh, seed=dh)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, v)
    args, kw = attention_case(torch, cuda, B=1, S=16, H=2, Hkv=1, dh=dh,
                              N=2, L=16, quant=True, varlen=False, seed=dh)
    with pytest.raises(ValueError, match="head_dim"):
        memo_attention(*args, **kw)


def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    """A kernel fills its output outside autograd, so each attention and
    wkv wrapper raises where its caller could need the gradient (grad
    enabled, an input requiring grad) instead of returning a detached
    result; under ``no_grad`` it launches. ``nn_search`` has no gradient
    in either package: it takes its inputs detached and launches."""
    q, k, v = flash_case(torch, cuda, B=1, S=16, H=2, Hkv=1, dh=64, seed=3)
    (mq, mk, mv, *rest), kw = attention_case(
        torch, cuda, B=1, S=16, H=2, Hkv=1, dh=64, N=2, L=16, quant=True,
        varlen=False, seed=3)
    r, kk, vv, w, u = wkv_case(torch, cuda, B=1, S=16, nh=2, N=64,
                               decay_mean=-3.5, seed=3)
    calls = {"flash_attention": lambda x: flash_attention(x, k, v),
             "memo_attention": lambda x: memo_attention(x, mk, mv, *rest,
                                                        **kw),
             "rwkv6": lambda x: wkv6(x, kk, vv, w, u)}
    for name, x in (("flash_attention", q), ("memo_attention", mq),
                    ("rwkv6", r)):
        with pytest.raises(RuntimeError, match="no backward"):
            calls[name](x.detach().requires_grad_(True))
        with torch.no_grad():
            calls[name](x.detach().requires_grad_(True))
    table = torch.randn(64, 32, device=cuda, requires_grad=True)
    n0 = nn_search.launches
    d, i = nn_search(table[:4] * 1.0, table)
    torch.cuda.synchronize()
    assert nn_search.launches == n0 + 1
    assert not d.requires_grad and torch.equal(
        i.cpu(), torch.arange(4, dtype=i.dtype))


@pytest.mark.parametrize("S,dh", [(65, 64), (129, 16)])
def test_flash_attention_unaligned_view(cuda, S, dh):
    """Strided views whose base is 4 bytes past an aligned allocation:
    the wrapper copies them for the 16-byte asynchronous copies and the
    kernel still launches."""
    q, k, v = flash_case(torch, cuda, B=2, S=S, H=4, Hkv=2, dh=dh, seed=S,
                         strided=True, offset=1)
    assert q.data_ptr() % 16 != 0
    n0 = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert (out - flash_attention_ref(q, k, v)).abs().max().item() <= ATOL


@pytest.mark.parametrize("B,S,nh,N,decay_mean,chunk", [
    (4, 1024, 40, 64, -6.0, None),              # rwkv6_3b's shape
] + wkv_cases(CHUNK))
def test_wkv6_against_plain(cuda, B, S, nh, N, decay_mean, chunk):
    """chip_smoke's synthetic cases (ragged and long S, every head size,
    slow to fast decay, S at the chunk edges, chunk decays that underflow,
    every swept chunk length) and rwkv6_3b's shape: one call, up to three
    launches, counts once."""
    args = wkv_case(torch, cuda, B=B, S=S, nh=nh, N=N,
                    decay_mean=decay_mean, seed=S)
    n0 = wkv6.launches
    out = wkv6(*args) if chunk is None else wkv6(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6.launches == n0 + 1
    assert torch.isfinite(out).all()
    err, tol = wkv_err(out, wkv6_ref(*args))
    print(f"rwkv6 S={S} N={N} chunk={chunk} max|err|={err:.3e} "
          f"(tolerance {tol:.1e})")
    assert err <= tol


def _small_session(cuda, **spec):
    """A 2-layer, d 128 bert_base session built on the card from 3
    calibration batches of 16 (96 entries)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import TemplateCorpus
    from repro_torch.memo import MemoSpec
    from repro_torch.memo.session import MemoSession
    from repro_torch.models import build_model
    cfg = get_reduced("bert_base").replace(n_layers=2, d_model=128,
                                           d_ff=256)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=32, n_templates=6,
                            slot_fraction=0.2)
    model = build_model(cfg, device=cuda)
    calib = [{"tokens": corpus.sample(16)[0]} for _ in range(3)]
    sess = MemoSession.build(model, model.init(0),
                             MemoSpec.flat(embed_steps=20, **spec),
                             batches=calib, device=cuda)
    return sess, corpus, calib


@pytest.mark.parametrize("level", ["all_hit", "moderate"])
def test_host_kernel_mode_matches_select(cuda, level):
    """Host-synchronous kernel mode (``memo_attention`` over the device
    DB by the host lookup's slots) against select mode on the same f16
    store: decisions equal except within SIM_MARGIN of the threshold,
    logits within 1e-4 (both replay the same f16 APMs; only the f32
    summation order differs); one launch per memoized layer and batch."""
    sess, corpus, calib = _small_session(cuda, device_fast_path=False,
                                         apm_codec="f16")
    requests = [calib[0], {"tokens": corpus.sample(16)[0]}]
    if level == "moderate":
        sess.autotune([{"tokens": corpus.sample(16)[0]}], "moderate")
    else:
        sess.spec.runtime.threshold = -1e9
    runs, per_path = {}, {}
    for mode in ("select", "kernel"):
        sess.spec.runtime.mode = mode
        runs[mode] = drive(torch, sess, requests, mode, per_path)
    assert per_path["kernel"]["memo_attention"] == 2 * len(requests)
    assert per_path["select"]["memo_attention"] == 0
    res = compare_decisions(torch, "host kernel", runs["kernel"], "select",
                            runs["select"], sess.spec.runtime.threshold,
                            1e-4, "f16 store: summation order")
    assert res["rows"] > 0
    if level == "all_hit":
        assert runs["kernel"]["rate"] == 1.0


def test_admission_reads_back(cuda):
    """Kernel-mode admission on the card: ``run_layers`` with capture on
    makes no host sync (``drive`` runs it under
    ``set_sync_debug_mode("error")``), every miss is admitted under a
    budget of 8 entries above the built store (so it evicts), and the
    last flush's entries read back from the device tier."""
    sess, corpus, _ = _small_session(cuda, mode="kernel", admit=True,
                                     recal_every=1, device_index="flat")
    store = sess.store
    store.budget_bytes = int((len(store) + 8.5) * store.entry_nbytes)
    admitted = []
    real_admit = store.admit

    def admit(*a, **k):
        slots = real_admit(*a, **k)
        admitted.append(slots)
        return slots
    store.admit = admit
    cal0 = store.sim_cal
    requests = [{"tokens": corpus.sample(8)[0]} for _ in range(3)]
    per_path = {}
    r = drive(torch, sess, requests, "admission", per_path, threshold=1e9)
    ss = store.stats
    assert per_path["admission"]["memo_attention"] == 2 * len(requests)
    assert r["stats"].n_admitted == 2 * 8 * len(requests)   # all missed
    assert ss.n_evicted > 0 and ss.n_delta_syncs > 0
    assert store.live_count == store.budget_entries
    assert store.sim_cal != cal0                            # recalibrated
    worst, _ = admission_read_back(torch, store, admitted[-1])
    assert worst <= 1e-6


def test_server_async_keeps_held_snapshots(cuda):
    """``MemoServer`` with asynchronous maintenance on the card: a batch
    prepared against one snapshot has its ``run_layers`` queued while the
    worker admits another batch's misses and delta-syncs them; the held
    snapshot's tensors stay equal to clones taken before, the new one
    reads the admitted rows back, and serving a few more requests leaves
    no maintenance error and the server healthy."""
    from repro_torch.core.runtime import Health
    sess, corpus, _ = _small_session(cuda, mode="bucket", admit=True,
                                     recal_every=1, device_index="flat")
    eng, store = sess.engine, sess.store
    eng.mc.threshold = 1e9                          # every row misses
    admitted = []
    real_admit = store.admit

    def admit(*a, **k):
        slots = real_admit(*a, **k)
        admitted.append(slots)
        return slots
    store.admit = admit

    def batch(n):
        return padded_batch([corpus.sample(1)[0][0, :30] for _ in range(n)],
                            32)
    with sess.serve(buckets=(16, 32), max_batch=8,
                    async_maintenance=True) as srv:
        prep = eng.prepare_batch(batch(4), sync_store=False)
        eng.run_layers(prep)
        _, _, payload = eng.finalize(prep)
        prep = eng.prepare_batch(batch(4), sync_store=False)
        view = prep.view
        held = (*view.db_parts, *view.search_args, view.lengths)
        clones = [t.clone() for t in held]
        eng.run_layers(prep)
        srv._enqueue_payload(payload)
        srv.drain_maintenance()
        out, _, _ = eng.finalize(prep)
        assert store.snapshot.generation > view.generation
        for c, t in zip(clones, held):
            assert torch.equal(c, t)
        admission_read_back(torch, store, admitted[-1])
        comps = serve_all(srv, [corpus.sample(1)[0][0, :n]
                                for n in (32, 30, 16, 12, 31)])
        srv.drain_maintenance()
    assert len(comps) == 5 and torch.isfinite(out).all()
    assert not srv.maintenance_errors and srv.health is Health.HEALTHY


def test_saved_session_loads_and_serves_bit_equal(cuda, tmp_path):
    """``save_and_load``: the session saved in format 3 and 2, loaded
    (format 3 mapped and read, format 2), serves the same batches in
    kernel and bucket mode with equal state, hit masks and slots and
    logits bit-equal, launching memo_attention / nn_search."""
    sess, corpus, calib = _small_session(cuda, mode="kernel",
                                         device_index="flat")
    sess.autotune([{"tokens": corpus.sample(16)[0]}], "moderate")
    requests = [calib[0], {"tokens": corpus.sample(16)[0]}]
    out = save_and_load(torch, sess, requests, str(tmp_path), {})
    for name in ("f3_mmap", "f3_ram", "f2"):
        assert out[f"launches_{name}_kernel"] == 2 * len(requests)
        assert out[f"launches_{name}_bucket"] == 2 * len(requests)


def test_capacity_promotion_launches_memo_attention(cuda, tmp_path):
    """``capacity_promotion`` at 16 host entries: the build's 96 entries
    are on disk, 80 demoted; a replay promotes its rows back (device rows
    byte-equal to the disk rows, CRC intact) and the next replay hits
    them with memo_attention launches."""
    import chip_smoke
    sess, _, calib = _small_session(cuda, mode="kernel",
                                    device_index="flat",
                                    capacity_dir=str(tmp_path / "tier"))
    real = chip_smoke.CAPACITY_HOST_ENTRIES
    chip_smoke.CAPACITY_HOST_ENTRIES = 16
    try:
        out = capacity_promotion(torch, sess, calib[0], {})
    finally:
        chip_smoke.CAPACITY_HOST_ENTRIES = real
    assert out["demoted"] == 80 and out["promoted"] > 0
    assert out["hits_on_promoted"] > 0 and out["memo_attention_launches"] > 0
    sess.store.capacity.close()


def test_nn_search_prefill_path_shapes(cuda):
    """nn_search at memoized prefill's shapes (B=32, dim 128, a flat
    table of 3,072 entries with as many slack rows) against the plain
    version, then the calls a memoized prefill batch of a small
    gpt2_small prefill session makes on the card: one per layer, each
    held to the plain version (``chip_smoke.hold_nn_calls``)."""
    from chip_smoke import RecordNN, hold_nn_calls
    from repro_torch.configs import get_reduced
    from repro_torch.data import TemplateCorpus
    from repro_torch.memo import MemoSpec
    from repro_torch.memo.session import MemoSession
    from repro_torch.models import build_model
    q, db, dn, p = nn_case(torch, cuda, B=32, dim=128, N=6144, seed=21)
    d, i = nn_search(q, db, db_norms=dn)
    rd, ri = nn_search_ref(q, db, dn)
    assert torch.equal(i, ri) and nn_tie_ok(db, i, p)
    assert (d - rd).abs().max().item() <= 1e-3 * max(
        1.0, rd.abs().max().item())
    cfg = get_reduced("gpt2_small").replace(n_layers=2)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=32, seed=0)
    model = build_model(cfg, device=cuda, attn_impl="kernel")
    calib = [{"tokens": corpus.sample(32)[0]} for _ in range(2)]
    sess = MemoSession.build(
        model, model.init(0), MemoSpec.flat(embed_steps=20, mode="kernel",
                                            prefill_enabled=True),
        batches=calib, device=cuda)
    errs = {"nn_search": 0.0}
    n0 = nn_search.launches
    with RecordNN() as rec:
        sess.engine.prefill({"tokens": corpus.sample(32)[0]})
    assert nn_search.launches == n0 + cfg.n_layers
    assert len(rec.calls) == cfg.n_layers
    assert rec.calls[0][0][0].shape == (32, 128)
    assert hold_nn_calls(torch, rec.calls, errs, "prefill") <= 1e-3


def test_memoized_prefill_on_card(cuda):
    """A small gpt2_small prefill session on the card: memoized prefill's
    ``run_layers`` makes no host sync (``drive``'s
    ``SyncFreeRunLayers``), launches nn_search once per layer and no
    memo_attention; a replayed calibration batch hits its own entries and
    takes the decode of their stored K/V as its caches."""
    from chip_smoke import SyncFreeRunLayers
    from repro_torch.configs import get_reduced
    from repro_torch.core.prefill import unstack_kv_rows
    from repro_torch.data import TemplateCorpus
    from repro_torch.memo import MemoSpec
    from repro_torch.memo.session import MemoSession
    from repro_torch.models import build_model
    cfg = get_reduced("gpt2_small").replace(n_layers=2)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=32, seed=0)
    model = build_model(cfg, device=cuda, attn_impl="kernel")
    calib = [{"tokens": corpus.sample(16)[0]} for _ in range(2)]
    sess = MemoSession.build(
        model, model.init(0), MemoSpec.flat(embed_steps=20, mode="kernel",
                                            prefill_enabled=True),
        batches=calib, device=cuda)
    eng, store = sess.engine, sess.store
    m0, n0 = memo_attention.launches, nn_search.launches
    with SyncFreeRunLayers(torch, eng) as ctx:
        lg, caches, st = eng.prefill(calib[0], threshold=-1e9)
    torch.cuda.synchronize()
    assert memo_attention.launches == m0
    assert nn_search.launches == n0 + cfg.n_layers
    assert st.n_hits == st.n_layer_attempts == cfg.n_layers * 16
    slots = torch.stack([p[3] for p in ctx.pends[-1]]).cpu()
    own = torch.arange(cfg.n_layers)[:, None] * 16 + torch.arange(16)
    assert torch.equal(slots.long(), own)
    by_li = eng._split_caches(caches)
    for li in eng.layers:
        rows = tuple(p.index_select(0, own[li].to(cuda))
                     for p in store.device_db.parts)
        k, v = unstack_kv_rows(store.codec.decode_kv_rows(rows).float(),
                               cfg.n_kv_heads, cfg.head_dim)
        assert torch.equal(by_li[li]["k"][:, :32], k)
        assert torch.equal(by_li[li]["v"][:, :32], v)
        assert by_li[li]["k"].shape[1] == 64             # 2·S
    le, _ = eng.prefill_exact(calib[0])
    assert (lg - le).abs().max().item() <= 2e-2


def test_prefill_decode_matches_forward_full_width(cuda):
    """Full-width gpt2_small (12 layers, d 768, random weights from a
    seed): ``Model(attn_impl="kernel").prefill`` of 120 tokens and 8
    ``decode_step``s against the plain full forward at the last 9
    positions, within chip_smoke's FORWARD_RTOL of the logits' scale."""
    import numpy as np
    from chip_smoke import prefill_decode_check
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("gpt2_small")
    kernel = build_model(cfg, device=cuda, attn_impl="kernel")
    plain = build_model(cfg, device=cuda)
    params = kernel.init(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128))).to(cuda)
    n0 = flash_attention.launches
    with torch.no_grad():
        full = plain.forward(params, {"tokens": tokens})[0]
        res = prefill_decode_check(torch, "gpt2_small", kernel, params,
                                   tokens, full)
    assert flash_attention.launches == n0 + cfg.n_layers
    assert res["agreement"] == 1.0


def _sharded_store(cuda, S=4, n=1024, dim=128, apm=(4, 32, 32), **kw):
    """A sharded int8 store of ``n`` random entries over ``S`` shards of
    one card, fully synced."""
    import numpy as np
    from repro_torch.core.shard import ShardedMemoStore, StoreMesh
    rng = np.random.default_rng(13)
    store = ShardedMemoStore(apm, dim, mesh=StoreMesh((cuda,) * S),
                             index_kind="exact", codec="int8", capacity=n,
                             hot_k=16, **kw)
    embs = rng.normal(0, 1, (n, dim)).astype(np.float32)
    slots = store.admit(rng.random((n, *apm)).astype(np.float16), embs)
    store.sync(force_full=True)
    return store, embs, slots


def test_sharded_search_fetch_matches_the_plain_combine(cuda):
    """``ShardedDeviceIndex.search_fetch`` over ``StoreMesh((cuda,) * 4)``
    at full routing and at nprobe 1: slots and rows equal to the same
    combine with every shard's nn_search taken by its plain version, S
    nn_search launches a call, one combine, no host sync."""
    import repro_torch.core.shard as shard
    for nprobe in (1 << 20, 1):
        store, embs, slots = _sharded_store(cuda, route_nprobe=nprobe)
        view = store.snapshot
        q = torch.from_numpy(embs[::7] + 0.01).to(cuda)
        n0, combines = nn_search.launches, []
        real = shard._ALL_GATHER
        shard._ALL_GATHER = lambda *a, **k: (combines.append(1)
                                             or real(*a, **k))
        try:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            d2, idx, rows = view.index.search_fetch(
                q, args=view.search_args, parts=view.db_parts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            shard._ALL_GATHER = real
        torch.cuda.synchronize()
        assert nn_search.launches - n0 == store.n_shards == 4
        assert len(combines) == 1
        real_nn = shard.nn_search
        shard.nn_search = nn_search_ref
        try:
            rd, ri, rrows = view.index.search_fetch(
                q, args=view.search_args, parts=view.db_parts)
        finally:
            shard.nn_search = real_nn
        assert torch.equal(idx, ri)
        for a, b in zip(rows, rrows):
            assert torch.equal(a, b)
        tol = 1e-3 * max(1.0, rd.abs().max().item())
        assert (d2 - rd).abs().max().item() <= tol
        if nprobe > 1:             # every shard competes: the exact top-1
            assert (idx[:, 0].cpu().numpy() == slots[::7]).all()


@pytest.mark.parametrize("S,N", [(4, 6144), (3, 1000)])
def test_mesh_search_matches_nn_search_on_card(cuda, S, N):
    """``mesh_search`` over a row-split table on one card (uneven splits
    too) against ``nn_search`` over the whole table: equal indices, d2
    within the kernel's tolerance, one nn_search launch a shard."""
    from repro_torch.core.shard import StoreMesh, mesh_search
    q, db, dn, _ = nn_case(torch, cuda, B=32, dim=128, N=N, seed=14)
    n0 = nn_search.launches
    d2, idx = mesh_search(db, q, StoreMesh((cuda,) * S))
    assert nn_search.launches - n0 == S
    rd, ri = nn_search(q, db, db_norms=dn)
    assert torch.equal(idx, ri)
    tol = 1e-3 * max(1.0, rd.abs().max().item())
    assert (d2 - rd).abs().max().item() <= tol
