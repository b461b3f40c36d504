#!/usr/bin/env python3
"""A scaled dry-run count against the walked record of the same pair.

    python3 scripts/dryrun_scale_check.py kimi_k2_1t_a32b train_4k pod256 \
        [--records experiments/dryrun_torch]

Counts the pair with ``launch/dryrun.py::run_one(scale=True)`` (its 1- and
2-unit variants walked and scaled to full depth) and prints each count of
the record's ``full`` beside the walked record's (``<arch>_<shape>_<grid>
.json`` in ``--records``, written by a walk of every layer), with the
scaled / walked ratio, and ends with one JSON line of them all. A
full-size pair's 1- and 2-unit walks take minutes of host time: run one
process a pair on a host that is not shared.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.launch.dryrun import run_one  # noqa: E402

KEYS = ("flops", "bytes", "transcendentals", "out_bytes", "arg_bytes",
        "peak_bytes", "temp_bytes")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("grid", choices=("pod256", "pod512"))
    ap.add_argument("--records", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    with open(os.path.join(args.records, f"{args.arch}_{args.shape}_"
                           f"{args.grid}.json")) as f:
        walked = json.load(f)
    assert "scaled" not in walked["meta"], "the record was not walked"
    rec = run_one(args.arch, args.shape, args.grid == "pod512",
                  verbose=False, scale=True)
    assert rec["status"] == "ok", rec.get("traceback")
    out = {"arch": args.arch, "shape": args.shape, "grid": args.grid,
           "elapsed_s": rec["elapsed_s"],
           "walked_elapsed_s": walked.get("elapsed_s")}
    for k in KEYS:
        s, w = rec["full"][k], walked["full"][k]
        out[k] = {"scaled": s, "walked": w, "ratio": s / w if w else None}
        print(f"{args.arch} {args.shape} {args.grid} {k}: scaled {s:.6e} "
              f"walked {w:.6e} ratio {out[k]['ratio']}")
    s, w = (rec["full"]["collectives"]["total"],
            walked["full"]["collectives"]["total"])
    out["collective_bytes"] = {"scaled": s, "walked": w}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
