#!/usr/bin/env python3
"""Build variants of the attention tile and time them on one card.

    python3 scripts/attention_tile_variants.py

Each variant is a copy of ``src/repro_torch/csrc`` with a few source
edits (tile sizes, launch bounds), built under ``build/`` beside the
port's own library. For each it prints ptxas's registers and spill bytes
per kernel, then times ``flash_attention`` at gpt2_small's shape (B=8,
S=1024, H=12, dh=64, causal) and ``memo_attention`` at bert_base's
serving shape (B=32, S=128, H=12, dh=64, 3072 int8 entries) with mixed,
all-miss and all-hit rows, each checked against its plain version
(chip_smoke's inputs, ATOL and event timing). SDPA's times close the
run. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

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
    "64-key softmax steps": [("attention_tile.cuh", "KC = 32", "KC = 64")],
    "3 blocks per SM": [
        (f, "__launch_bounds__(NT)", "__launch_bounds__(NT, 3)")
        for f in ("flash_attention.cu", "memo_attention.cu")],
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


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.memo_attention.ops import memo_attention
    from repro_torch.kernels.memo_attention.ref import memo_attention_ref

    if not torch.cuda.is_available():
        print("attention_tile_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line())
    build.SOURCES = ("memo_attention.cu", "flash_attention.cu")
    build.SIGNATURES = {k: v for k, v in build.SIGNATURES.items()
                        if "attention" in k}
    csrc = build.CSRC
    fq = cs.flash_case(torch, dev, B=8, S=1024, H=12, Hkv=12, dh=64, seed=1)
    (q, k, v, db, hit_idx, hit), kw = cs.attention_case(
        torch, dev, B=32, S=128, H=12, Hkv=12, dh=64, N=3072, L=128,
        quant=True, varlen=False, seed=2)
    masks = {"mixed": hit, "all-miss": torch.zeros_like(hit),
             "all-hit": torch.ones_like(hit)}
    for name, edits in VARIANTS.items():
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
        err = (flash_attention(*fq) - flash_attention_ref(*fq)).abs().max()
        cs.require(err.item() <= cs.ATOL, f"flash_attention error {err}")
        ms = cs.event_ms(lambda: flash_attention(*fq))
        line = [f"flash_attention {ms:.4f} ms"]
        for label, h in masks.items():
            args = (q, k, v, db, hit_idx, h)
            err = (memo_attention(*args, **kw)
                   - memo_attention_ref(*args, **kw)).abs().max()
            cs.require(err.item() <= cs.ATOL, f"memo_attention error {err}")
            ms = cs.event_ms(lambda: memo_attention(*args, **kw))
            line.append(f"memo_attention {label} {ms:.4f} ms")
        print("   " + ", ".join(line))
    qt, kt, vt = (x.transpose(1, 2) for x in fq)
    ms = cs.event_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    print(f"SDPA (8, 1024, 12, 64) causal {ms:.4f} ms")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = cs.event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    print(f"SDPA (32, 128, 12, 64) {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
