#!/usr/bin/env python3
"""Build variants of the attention tile and time them on one card.

    python3 scripts/attention_tile_variants.py [--old CSRC] [--dh 64 128]

Each variant is a copy of ``src/repro_torch/csrc`` with a few source
edits (tile sizes, launch bounds), built under ``build/`` beside the
port's own library; ``--old CSRC`` adds an earlier ``csrc`` directory
(unpacked from git under ``build/``) as the variant "old", run before and
after the others so that the card's drift shows. For each it prints
ptxas's registers and spill bytes per kernel, then times, at each head
width asked for (``--dh``):

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
* dh 256: ``flash_attention`` at recurrentgemma_2b's forward length
  (B=1, S=2560, H=10, Hkv=1, causal) and ``memo_attention`` at its
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
    # (dh 256's 32-key tiles hold one 32-key step: not built here)
    "64-key softmax steps": [("attention_tile.cuh", "KC = 32", "KC = 64")]
    + [(f, a, b) for f in ("flash_attention.cu", "memo_attention.cu")
       for a, b in (("case 256:", "case -256:"),
                    ("launch<256>(", "launch<128>("))],
    "Q in shared memory at every width": [
        ("attention_tile.cuh", "Q_SMEM = DH > 64", "Q_SMEM = DH > 0")],
    "3 blocks per SM": [
        (f, "__launch_bounds__(NT)", "__launch_bounds__(NT, 3)")
        for f in ("flash_attention.cu", "memo_attention.cu")],
    # the K/V row copy over the flat chunk index (the tile before the
    # padded passes): the dh-112 kernels spill 4-20 bytes this way
    # past dh 128, blocks of 64 of O's columns in place of 128: half the
    # registers for O and the P.V accumulator, four softmax passes a row
    # tile instead of two
    "dh 256 in 64-column blocks": [
        ("attention_tile.cuh", "return dh > 128 ? 128 : dh;",
         "return dh > 128 ? 64 : dh;")],
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
}

# dh -> flash_attention shapes (B, S, H, Hkv) and the memo_attention one
# (B, S, H, Hkv, N, causal)
SHAPES = {
    64: ([(8, 1024, 12, 12)], (32, 128, 12, 12, 3072, False)),
    112: ([(2, 1024, 64, 8)], (32, 128, 64, 8, 128, True)),
    128: ([(32, 128, 12, 2), (2, 1024, 32, 8)],
          (32, 128, 12, 2, 3584, True)),
    256: ([(1, 2560, 10, 1)], (32, 128, 10, 1, 1024, True)),
}


def ptxas_summary(log: str) -> str:
    """'kernel<args>: registers r / spill-store bytes' per entry."""
    out, fn, spill = [], None, "?"
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
    build.SIGNATURES = {k: v for k, v in build.SIGNATURES.items()
                        if "attention" in k}
    csrc = build.CSRC
    cases = {}
    for dh in args.dh:
        flashes, (B, S, H, Hkv, N, causal) = SHAPES[dh]
        fq = [(f"({b}, {s}, {h}/{hk}, {dh})",
               cs.flash_case(torch, dev, B=b, S=s, H=h, Hkv=hk, dh=dh,
                             seed=1))
              for b, s, h, hk in flashes]
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
        t0 = time.perf_counter()
        info = build.build_info()
        print(f"== {name} (built in {time.perf_counter() - t0:.0f}s): "
              f"{ptxas_summary(info['log'])}")
        for dh, (fq, (label, margs, kw, masks)) in cases.items():
            if f"case {dh}:" not in (src / "flash_attention.cu").read_text():
                print(f"   dh {dh}: not in this variant")
                continue
            line = []
            for flabel, f in fq:
                err = (flash_attention(*f) - flash_attention_ref(
                    *f)).abs().max()
                cs.require(err.item() <= cs.ATOL,
                           f"flash_attention error {err}")
                ms = cs.event_ms(lambda: flash_attention(*f))
                line.append(f"flash_attention {flabel} {ms:.4f} ms")
            for mlabel, h in masks.items():
                a = margs + (h,)
                err = (memo_attention(*a, **kw)
                       - memo_attention_ref(*a, **kw)).abs().max()
                cs.require(err.item() <= cs.ATOL,
                           f"memo_attention error {err}")
                ms = cs.event_ms(lambda: memo_attention(*a, **kw))
                line.append(f"memo_attention {label} {mlabel} {ms:.4f} ms")
            print(f"   dh {dh}: " + ", ".join(line))
    for dh, (fq, (label, margs, kw, _)) in cases.items():
        for flabel, f in fq:
            qt, kt, vt = cs.sdpa_args(*f)
            ms = cs.event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            print(f"SDPA {flabel} causal {ms:.4f} ms")
        qt, kt, vt = cs.sdpa_args(*margs[:3])
        ms = cs.event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"]))
        print(f"SDPA {label} {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
