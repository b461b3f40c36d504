#!/usr/bin/env python3
"""Time versions of the nn_search kernel side by side on one card.

    git archive <commit> src/repro_torch/csrc/nn_search.cu | tar -x -C build/base
    python3 scripts/nn_search_versions.py \
        [--old build/base/src/repro_torch/csrc/nn_search.cu]

The versions: ``--old``, a ``nn_search.cu`` of the split-N two-kernel
design (C entry point ``nn_search_f32(q, db, norms, part_d, part_i,
out_d, out_i, B, N, dim, rows_per_split, n_split, stream)``, partials
sized per call as its wrapper sized them: about two blocks per SM, whole
32-row tiles), built alone into ``build/``; and ``VARIANTS``: the
committed ``csrc/nn_search.cu`` and diagnostic edits of it, each built
in a copy of ``csrc`` under ``build/``. For each it prints ptxas's
registers and spill bytes. At each shape of chip_smoke's
nn_search sweep (B=32, dim=128, N = 6144, 65,536 and 1,048,576, and
B=128 at N = 65,536; tables from ``chip_smoke.nn_case``, the last eighth
TOMBSTONE) every version is checked against the plain version (indices
equal) and timed with ``chip_smoke.event_ms``, in order and then in
reverse. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((32, 6144), (32, 65536), (32, 1 << 20), (128, 65536))


# Diagnostic edits of the committed kernel, whose results are wrong by
# design (not checked): no products (no shared reads, no FMAs: the loads
# and the pipeline alone), no loads past the prologue (the products on
# stale tiles alone), no cross-block tail (no global atomics, no ticket,
# no outputs)
NO_PRODUCTS = [("for (int k = 0; k < nk4; ++k) {\n      float4 a[4], b[4];",
                "for (int k = 0; k < 0; ++k) {\n      float4 a[4], b[4];")]
NO_LOADS = [("if (t + STAGES - 1 < t1) load_tile(t + STAGES - 1);",
             "if (false) load_tile(t + STAGES - 1);")]
NO_TAIL = [("if (tid < NQ && qb0 + tid < B && sm.key[tid] != EMPTY) {",
            "if (false) {"),
           ("atomicAdd(&tickets[blockIdx.y], 1u) == (unsigned)n_ranges - 1",
            "0")]

# name -> (edits of the committed nn_search.cu, checked against the plain
# version)
VARIANTS = {
    "committed": ([], True),
    "committed, no products": (NO_PRODUCTS, False),
    "committed, no loads": (NO_LOADS, False),
    "committed, no tail": (NO_TAIL, False),
}


def ptxas_summary(log: str) -> str:
    """'vec4=<0|1>:registers r/spill-store bytes B' per instantiation
    of the nn_search kernel."""
    out, fn, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*nn_search_kernelILb(\d)",
                      line)
        if m:
            fn = f"vec4={m.group(1)}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append(f"{fn}:{m.group(1)}r/{spill}B")
            fn = None
    return " ".join(out)


def build_old(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build
    text = src.read_bytes()
    lib = build.BUILD_DIR / (
        f"nn_search_old_{hashlib.sha256(text).hexdigest()[:16]}.so")
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(src), "-o",
             str(lib)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{out.stdout}"
                               f"{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.nn_search_f32.argtypes = [P] * 7 + [I] * 5 + [P]
    dll.nn_search_f32.restype = I
    return dll


def old_search(dll, n_sms):
    """The earlier wrapper's launch: rows per split for about two blocks
    per SM, whole 32-row tiles; partials allocated per call."""
    import torch

    def search(q, db, db_norms=None):
        B, dim = q.shape
        N = db.shape[0]
        want = max(1, (2 * n_sms) // -(-B // 32))
        rows = -(-N // want)
        rows = max(32, -(-rows // 32) * 32)
        n_split = -(-N // rows)
        part_d = torch.empty((n_split, B), device=q.device)
        part_i = torch.empty((n_split, B), dtype=torch.int32, device=q.device)
        out_d = torch.empty((B,), device=q.device)
        out_i = torch.empty((B,), dtype=torch.int32, device=q.device)
        err = dll.nn_search_f32(
            q.data_ptr(), db.data_ptr(),
            db_norms.data_ptr() if db_norms is not None else None,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), B, N, dim, rows, n_split,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old nn_search launch failed: {err}")
        return out_d, out_i
    return search


def variant_search(csrc, name, edits):
    """Build a copy of csrc whose nn_search.cu has ``edits``; returns a
    search through that library."""
    from repro_torch.kernels import build
    from repro_torch.kernels.nn_search import ops
    src = build.BUILD_DIR / ("nn_variant_" + re.sub(r"\W+", "_", name))
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    text = (src / "nn_search.cu").read_text()
    for a, b in edits:
        if a not in text:
            raise RuntimeError(f"{a!r} not in nn_search.cu")
        text = text.replace(a, b)
    (src / "nn_search.cu").write_text(text)
    build.CSRC, build._State.lib, build._State.log = src, None, ""
    info = build.build_info()
    lib = build._State.lib
    print(f"== {name}: {ptxas_summary(info['log'])}; {ops.resources()}")

    def search(q, db, db_norms=None):
        build._State.lib = lib
        return ops.nn_search(q, db, db_norms=db_norms)
    return search


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.nn_search.ops import _n_sms
    from repro_torch.kernels.nn_search.ref import nn_search_ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path,
                    help="nn_search.cu of the split-N two-kernel design")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nn_search_versions: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi)
    build.SOURCES = ("memo_attention.cu", "nn_search.cu")
    build.SIGNATURES = {k: v for k, v in build.SIGNATURES.items()
                        if k.startswith(("memo", "nn"))}
    versions = {}
    if args.old:
        versions["old"] = old_search(build_old(args.old), _n_sms(0))
    csrc = build.CSRC
    checked = {"old"}
    for name, (edits, check) in VARIANTS.items():
        versions[name] = variant_search(csrc, name, edits)
        if check:
            checked.add(name)
    rows = []
    order = list(versions) + list(reversed(versions))
    for j, (B, N) in enumerate(SHAPES):
        q, db, dn, _ = cs.nn_case(torch, dev, B=B, dim=128, N=N,
                                  seed=600 + j)
        for name, fn in versions.items():
            if name in checked:
                cs.nn_check(fn, nn_search_ref, q, db, dn,
                            f"{name} B={B} N={N}")
        times = {name: [] for name in versions}
        for name in order:
            fn = versions[name]
            times[name].append(cs.event_ms(lambda: fn(q, db, db_norms=dn)))
        b_ms, b_by = cs.nn_bound(B, N, 128)
        print(f"[versions] nn_search B={B} dim=128 N={N} (bound {b_ms:.4f} "
              f"ms, {b_by}):")
        for name, t in times.items():
            print(f"[versions]   {name}: {t[0]:.4f} / {t[1]:.4f} ms")
        rows.append(dict(B=B, N=N, dim=128, bound_ms=b_ms, ms=times))
        del q, db, dn
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"nn_search_versions": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
