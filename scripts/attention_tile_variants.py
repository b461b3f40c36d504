#!/usr/bin/env python3
"""Build variants of the attention tiles and time them on one card.

    python3 scripts/attention_tile_variants.py [--old CSRC] [--dh 64 128]
        [--variants NAME ...]

Each variant is a copy of ``src/repro_torch/csrc`` with a few source
edits (tile sizes, stages, producer warps, launch bounds), built under
``build/`` beside the port's own library; ``--old CSRC`` adds an earlier
``csrc`` directory (unpacked from git under ``build/``) as the variant
"old", run before and after the others so that the card's drift shows.
Variants named "diagnostic: ..." take a piece of work out of the wgmma
tile (head_dim 112, 128 and 256: the split, the copies, a product, the
exponentials, dh 256's exchange of partial scores) to show what it
costs; their outputs are wrong and are not checked. "wgmma: dh 256 in one
block" builds the design measured against dh 256's cluster: each block
of a row tile computes QK^T over all 256 columns itself, one stage. For each variant it prints ptxas's registers and spill bytes
per kernel, then times, at each head width asked for (``--dh``):

* dh 64: ``flash_attention`` at gpt2_small's shape (B=8, S=1024, H=12,
  causal) and ``memo_attention`` at bert_base's serving shape (B=32,
  S=128, H=12, 3072 int8 entries);
* dh 112: ``flash_attention`` at kimi_k2's forward (B=2, S=1024, H=64,
  Hkv=8, causal) and ``memo_attention`` at its serving shape (B=32,
  S=128, 128 int8 entries, causal);
* dh 128: ``flash_attention`` at qwen2_1_5b's serving shape (B=32,
  S=128, H=12, Hkv=2, causal) and at qwen3_8b's (B=2, S=1024, H=32,
  Hkv=8, causal), and ``memo_attention`` at qwen2_1_5b's serving shape
  (3584 int8 entries, causal);
* dh 256: ``flash_attention`` at recurrentgemma_2b's forward (B=1,
  S=2560, H=10, Hkv=1, causal, window 2048) and ``memo_attention`` at its
  serving shape (B=32, S=128, 1024 int8 entries, causal);

``memo_attention`` with mixed, all-miss and all-hit rows, everything
checked against its plain version first (chip_smoke's inputs, ATOL and
event timing). A variant whose kernels do not take a width (an old tree
before dh 128) skips that width. SDPA's times close the run. Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import re
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# name -> [(file in csrc, text, replacement)]
VARIANTS = {
    "as committed": [],
    # the mma.sync tile (dh 16, 32, 64)
    "64-key softmax steps": [("attention_tile.cuh", "KC = 32", "KC = 64")],
    "Q in shared memory at every width": [
        ("attention_tile.cuh", "Q_SMEM = DH > 64", "Q_SMEM = DH > 0")],
    "3 blocks per SM": [
        (f, "__launch_bounds__(attn_wg::threads(DH))",
         "__launch_bounds__(attn_wg::threads(DH), attn_wg::uses(DH) ? 1 : 3)")
        for f in ("flash_attention.cu", "memo_attention.cu")],
    # the K/V row copy over the flat chunk index (the tile before the
    # padded passes)
    "row copy over the flat chunk index": [(
        "attention_tile.cuh",
        """  const int c = threadIdx.x % CPP;
  if (c >= CPR) return;
#pragma unroll
  for (int it = 0; it < ROWS / RPP; ++it) {
    const int j = threadIdx.x / CPP + it * RPP;""",
        """#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int i = threadIdx.x + it * NT, j = i / CPR, c = i % CPR;""")],
    # the wgmma tile (attention_wgmma.cuh): ring depth, key-tile width (a
    # 64-key stage, 160 KB at dh 128, fits only alone beside Q), producer
    # warps, and the split's rounding by cvt.rna.tf32.f32 (the same bits
    # as the committed integer operations); at dh 256, one block a column
    # half computing QK^T over all of dh (no cluster, one stage)
    "wgmma: dh 256 in one block": [
        ("attention_wgmma.cuh", "bool CLUSTER = true;",
         "bool CLUSTER = false;")],
    # dh 256's exchange of partial scores by plain remote stores and one
    # remote release arrival a consumer thread (128 a phase), in place of
    # st.async counted on the mbarrier's transaction bytes
    "wgmma: dh 256 exchange by st.shared::cluster": [
        ("attention_wgmma.cuh", f"mbar_init(saddr(base + Lay::bar({i})), 1);",
         f"mbar_init(saddr(base + Lay::bar({i})), NC);") for i in (0, 1)] + [
        ("attention_wgmma.cuh",
         "  if (i == 0) mbar_expect(bar, Lay::X_BYTES);\n", ""),
        ("attention_wgmma.cuh",
         """    st_async(there + k * NC * 16, s[k][0], s[k][1], s[k][2], s[k][3],
             there_bar);
""", """    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
                 ::"r"(there + k * NC * 16), "f"(s[k][0]), "f"(s[k][1]),
                 "f"(s[k][2]), "f"(s[k][3]) : "memory");
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
               "[%0];" ::"r"(there_bar) : "memory");
""")],
    # dh 256's opening cluster barrier waited on at once, before Q's fill
    "wgmma: dh 256 cluster barrier before Q's fill": [
        ("attention_wgmma.cuh",
         "if constexpr (Lay::PAIR) cluster_wait();   // cluster_open's", ""),
        ("attention_wgmma.cuh", """    cluster_arrive();
  }
}
// ... and last""", """    cluster_arrive();
    cluster_wait();
  }
}
// ... and last""")],
    "wgmma: one stage": [
        ("attention_wgmma.cuh", "int STAGES = 2;", "int STAGES = 1;")],
    "wgmma: 64-key tiles, one stage": [
        ("attention_wgmma.cuh", "int KT = 32;", "int KT = 64;"),
        ("attention_wgmma.cuh", "int STAGES = 2;", "int STAGES = 1;")],
    "wgmma: one producer warp": [
        ("attention_wgmma.cuh", "int PW = 4;", "int PW = 1;")],
    "wgmma: two producer warps": [
        ("attention_wgmma.cuh", "int PW = 4;", "int PW = 2;")],
    "wgmma: cvt.rna in the split": [(
        "attention_wgmma.cuh",
        "  hi = rna(x);\n  lo = rna(x - __uint_as_float(hi));\n",
        "  attn_tile::split(x, hi, lo);\n")],
    "diagnostic: no split": [
        ("attention_wgmma.cuh",
         "        split_k<Lay>(base + Lay::k(st), p);\n"
         "        split_v<Lay>(base + Lay::vth(st), base + Lay::vl(st), p);\n",
         ""),
        ("attention_wgmma.cuh",
         "        split_k<Lay>(base + Lay::k(st), p);\n"
         "        split_v_regs<Lay>(base + Lay::vth(st), vr, p);\n", ""),
        ("memo_attention.cu",
         "        attn_wg::split_v_regs<Lay>(base + Lay::vth(st), vr, p);\n",
         ""),
        ("memo_attention.cu",
         "        attn_wg::split_v<Lay>(base + Lay::vth(st), base + Lay::vl(st),"
         " p);\n", "")],
    "diagnostic: no copies": [
        ("attention_wgmma.cuh", "      load(j, j);\n", ""),
        ("attention_wgmma.cuh", "      load(j + ST, st);\n", ""),
        ("attention_wgmma.cuh",
         "      vr.x[it][e] = r < S ? vb[(size_t)r * vs + c.d] : 0.f;\n",
         "      vr.x[it][e] = 0.f;\n")],
    "diagnostic: no exchange": [
        ("attention_wgmma.cuh",
         "    if constexpr (Lay::PAIR) exchange<Lay>(base, s, j);\n", "")],
    "diagnostic: no QK^T products": [
        ("attention_wgmma.cuh", f"      wgmma_ss({a}, kstep<BQ>({b}, kk), "
         f"kstep<2 * KT>(dk, kk), kk > 0);\n", "")
        for a, b in (("hk", "dqh"), ("lk", "dql"))],
    "diagnostic: no P.V products": [
        ("attention_wgmma.cuh", f"      wgmma_rs(acc[h], {a}[kk], "
         f"kstep<DV>({b}, kk) + h * HALF, {c});\n", "      ;\n")
        for a, b, c in (("al", "vh", "kk > 0"), ("ah", "vl", "1"),
                        ("ah", "vh", "1"))],
    "diagnostic: no exponentials": [
        ("attention_wgmma.cuh", "expf(s[kk][e] - m[e >> 1])",
         "(s[kk][e] - m[e >> 1])")],
}

# dh -> flash_attention shapes (B, S, H, Hkv, window; causal) and the
# memo_attention one (B, S, H, Hkv, N, causal)
SHAPES = {
    64: ([(8, 1024, 12, 12, None)], (32, 128, 12, 12, 3072, False)),
    112: ([(2, 1024, 64, 8, None)], (32, 128, 64, 8, 128, True)),
    128: ([(32, 128, 12, 2, None), (2, 1024, 32, 8, None)],
          (32, 128, 12, 2, 3584, True)),
    256: ([(1, 2560, 10, 1, 2048)], (32, 128, 10, 1, 1024, True)),
}


def ptxas_summary(log: str) -> str:
    """'kernel<args>: registers r / spill-store bytes' per entry, and how
    many functions ptxas serialized wgmmas in (its C7514-style notes)."""
    out, fn, spill = [], None, "?"
    serialized = sum("wgmma.mma_async instructions are serialized" in line
                     for line in log.splitlines())
    if serialized:
        out.append(f"[wgmma serialized in {serialized} functions]")
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(\d+)"
                      r"(flash_attention_kernel|memo_attention_kernel)"
                      r"(I\S*?EE)", line)
        if m:
            fn = m.group(2) + m.group(3)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append(f"{fn}:{m.group(1)}r/{spill}B")
            fn = None
    return " ".join(out)


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.memo_attention.ops import memo_attention
    from repro_torch.kernels.memo_attention.ref import memo_attention_ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier csrc directory to time too")
    ap.add_argument("--dh", type=int, nargs="+", default=[64, 128],
                    choices=sorted(SHAPES))
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_tile_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line())
    build.SOURCES = ("memo_attention.cu", "flash_attention.cu")
    # the attention entry points an earlier csrc has too
    build.SIGNATURES = {k: v for k, v in build.SIGNATURES.items()
                        if k.endswith("attention_f32")}
    csrc, headers = build.CSRC, build.HEADERS
    cases = {}
    for dh in args.dh:
        flashes, (B, S, H, Hkv, N, causal) = SHAPES[dh]
        fq = [(f"({b}, {s}, {h}/{hk}, {dh})"
               + (f" window {w}" if w else ""), w,
               cs.flash_case(torch, dev, B=b, S=s, H=h, Hkv=hk, dh=dh,
                             seed=1))
              for b, s, h, hk, w in flashes]
        (q, k, v, db, hit_idx, hit), kw = cs.attention_case(
            torch, dev, B=B, S=S, H=H, Hkv=Hkv, dh=dh, N=N, L=S,
            quant=True, varlen=False, seed=2)
        kw["causal"] = causal
        memo = (f"({B}, {S}, {H}/{Hkv}, {dh}) causal={causal}",
                (q, k, v, db, hit_idx), kw,
                {"mixed": hit, "all-miss": torch.zeros_like(hit),
                 "all-hit": torch.ones_like(hit)})
        cases[dh] = (fq, memo)

    runs = [(name, VARIANTS[name]) for name in args.variants]
    if args.old:
        runs = [("old", None)] + runs + [("old", None)]
    for name, edits in runs:
        if edits is None:
            src = Path(args.old).resolve()
        else:
            src = build.BUILD_DIR / ("variant_" + re.sub(r"\W+", "_", name))
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(csrc, src)
            for f, a, b in edits:
                text = (src / f).read_text()
                cs.require(a in text, f"{a!r} not in {f}")
                (src / f).write_text(text.replace(a, b))
        build.CSRC, build._State.lib, build._State.log = src, None, ""
        build.HEADERS = tuple(h for h in headers if (src / h).exists())
        diagnostic = name.startswith("diagnostic")
        t0 = time.perf_counter()
        info = build.build_info()
        print(f"== {name} (built in {time.perf_counter() - t0:.0f}s): "
              f"{ptxas_summary(info['log'])}")
        for dh, (fq, (label, margs, kw, masks)) in cases.items():
            if f"case {dh}:" not in (src / "flash_attention.cu").read_text():
                print(f"   dh {dh}: not in this variant")
                continue
            line = []
            for flabel, w, f in fq:
                err = (flash_attention(*f, window=w) - flash_attention_ref(
                    *f, window=w)).abs().max()
                cs.require(diagnostic or err.item() <= cs.ATOL,
                           f"flash_attention error {err}")
                ms = cs.event_ms(lambda: flash_attention(*f, window=w))
                line.append(f"flash_attention {flabel} {ms:.4f} ms")
            for mlabel, h in masks.items():
                a = margs + (h,)
                err = (memo_attention(*a, **kw)
                       - memo_attention_ref(*a, **kw)).abs().max()
                cs.require(diagnostic or err.item() <= cs.ATOL,
                           f"memo_attention error {err}")
                ms = cs.event_ms(lambda: memo_attention(*a, **kw))
                line.append(f"memo_attention {label} {mlabel} {ms:.4f} ms")
            print(f"   dh {dh}: " + ", ".join(line))
    for dh, (fq, (label, margs, kw, _)) in cases.items():
        for flabel, w, f in fq:
            ms = cs.event_ms(cs.sdpa_call(*f, True, w))
            print(f"SDPA {flabel} causal {ms:.4f} ms")
        qt, kt, vt = cs.sdpa_args(*margs[:3])
        ms = cs.event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"]))
        print(f"SDPA {label} {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
