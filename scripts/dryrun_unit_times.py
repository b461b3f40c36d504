#!/usr/bin/env python3
"""Size a dry-run pair before running it at full size: the host seconds
of its 1-unit and 2-unit variants at reduced widths on the production
grid, and the full depth's wall extrapolated from them.

    python3 scripts/dryrun_unit_times.py kimi_k2_1t_a32b train_4k pod512

On ``meta`` tensors an op costs the same at any width, so a pair's wall
follows its op count: its layers, the MoE's dispatch chunks and slots,
the recurrences' time steps. The config keeps the arch's depth
structure (layer pattern, leading dense layers, encoder depth, frames),
its MoE routing (experts, top-k, dispatch chunks) and the shape; the
widths are the arch's reduced ones, the MoE's d_ff 128 (16 divides it).
One warm-up count comes first. Prints one JSON line: the two walls,
``est_full`` (unit1 + (reps − 1)·(unit2 − unit1)), ``est_pair`` (with
the unit passes a single-pod record adds) and the peak resident GB.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from dataclasses import replace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def shrunk(arch):
    """The reduced widths with the full config's depth and routing."""
    full, red = get_config(arch), get_reduced(arch)
    kw = dict(n_layers=full.n_layers, layer_pattern=full.layer_pattern,
              dense_first_n=full.dense_first_n)
    if full.moe is not None:
        kw["moe"] = replace(full.moe, d_ff=128)
    if full.encoder is not None:
        kw["encoder"] = replace(red.encoder, n_layers=full.encoder.n_layers,
                                n_frames=full.encoder.n_frames)
    return red.replace(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("grid", choices=("pod256", "pod512"))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cfg = shrunk(args.arch)
    mesh = make_production_mesh(multi_pod=args.grid == "pod512")
    dryrun.count_step(args.arch, args.shape, mesh,
                      cfg=dryrun.small_variant(cfg, 1))        # warm-up
    t = {}
    for n in (1, 2):
        t0 = time.time()
        dryrun.count_step(args.arch, args.shape, mesh,
                          cfg=dryrun.small_variant(cfg, n))
        t[n] = time.time() - t0
    reps = dryrun.unit_info(cfg)[2]
    full = t[1] + (reps - 1) * (t[2] - t[1])
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "grid": args.grid,
        "t1": round(t[1], 2), "t2": round(t[2], 2), "reps": reps,
        "est_full": round(full, 1),
        "est_pair": round(full + (t[1] + t[2]
                                  if args.grid == "pod256" else 0), 1),
        "maxrss_gb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)}))


if __name__ == "__main__":
    main()
