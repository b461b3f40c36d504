#!/usr/bin/env python3
"""Every (arch × shape × grid) pair of the dry run, and the hillclimb, in
batches on one host: one process a pair, never more at once than
``--jobs`` (the host's cores by default), the costliest first.

    python3 scripts/dryrun_batch.py [--jobs 8] [--hillclimb] [--timeout S]
    python3 scripts/dryrun_batch.py --table      # PERF.md's table

Each pair runs ``python -m repro_torch.launch.dryrun --arch A --shape S
--single-pod-only | --multi-pod-only --skip-existing`` with
``CUDA_VISIBLE_DEVICES=""`` and ``OMP_NUM_THREADS=1``: the dry run
counts a step on ``meta`` tensors, on the host alone. A pair whose
record is already in ``--out`` is not started again, so a batch cut by a
time limit is resumed by running the same command. ``--hillclimb`` adds
``python -m repro_torch.launch.hillclimb --pair 1``, ``2`` and ``3``.

``<out>/batch.json`` keeps, for every process this run started, its wall,
its exit code, its peak resident memory, and the most processes that
ran at once while it ran, beside the host's CPU model and core count
and the card's name and power limit (the host is that card's).
``--table`` prints one markdown row a pair from the records and the
batch files.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import platform
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402

# launch/dryrun.py's ASSIGNED, without importing torch into this process
# (each pair's own process imports it)
ASSIGNED = [a for a in ARCH_IDS if a not in ("bert_base", "gpt2_small")]

GRIDS = ("pod256", "pod512")
HILLCLIMB_OUT = "experiments/hillclimb_torch"
# seconds each pair took on an 8-core host running 8 pairs at once (the
# batch's order only; a pair not listed takes seconds)
COST_HINT = {
    ("kimi_k2_1t_a32b", "train_4k", "pod256"): 2775,
    ("rwkv6_3b", "prefill_32k", "pod256"): 1973,
    ("dbrx_132b", "train_4k", "pod512"): 1862,
    ("rwkv6_3b", "prefill_32k", "pod512"): 1785,
    ("rwkv6_3b", "train_4k", "pod256"): 1700,
    ("rwkv6_3b", "train_4k", "pod512"): 1564,
    ("kimi_k2_1t_a32b", "prefill_32k", "pod512"): 1040,
    ("dbrx_132b", "train_4k", "pod256"): 1022,
    ("kimi_k2_1t_a32b", "prefill_32k", "pod256"): 561,
    ("dbrx_132b", "prefill_32k", "pod512"): 360,
    ("kimi_k2_1t_a32b", "decode_32k", "pod256"): 303,
    ("kimi_k2_1t_a32b", "decode_32k", "pod512"): 283,
    ("recurrentgemma_2b", "train_4k", "pod256"): 274,
    ("kimi_k2_1t_a32b", "train_4k", "pod512"): 250,     # scaled
    ("dbrx_132b", "prefill_32k", "pod256"): 206,
    ("dbrx_132b", "decode_32k", "pod512"): 190,
    ("recurrentgemma_2b", "train_4k", "pod512"): 184,
    ("dbrx_132b", "decode_32k", "pod256"): 168,
    ("recurrentgemma_2b", "prefill_32k", "pod256"): 195,
    ("recurrentgemma_2b", "prefill_32k", "pod512"): 125,
}
HILLCLIMB_HINT = {1: 26, 2: 1570, 3: 11}


def cpu_model() -> str:
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        for line in out.splitlines():
            if line.startswith("Model name:"):
                return line.split(":", 1)[1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return platform.processor() or "unknown"


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def key(arch, shape, grid):
    return f"{arch}_{shape}_{grid}"


def jobs(out, hillclimb, hillclimb_out=HILLCLIMB_OUT):
    """(name, argv, hint) of every pair without a record, then the
    hillclimb's pairs, costliest first."""
    todo = []
    for arch in ASSIGNED:
        for shape in INPUT_SHAPES:
            for grid in GRIDS:
                name = key(arch, shape, grid)
                if os.path.exists(os.path.join(out, name + ".json")):
                    continue
                flag = ("--multi-pod-only" if grid == "pod512"
                        else "--single-pod-only")
                hint = COST_HINT.get((arch, shape, grid), 10)
                todo.append((name, ["-m", "repro_torch.launch.dryrun",
                                    "--arch", arch, "--shape", shape, flag,
                                    "--skip-existing", "--out", out], hint))
    if hillclimb:
        for pair, hint in HILLCLIMB_HINT.items():
            todo.append((f"hillclimb_pair{pair}",
                         ["-m", "repro_torch.launch.hillclimb", "--pair",
                          str(pair), "--out", hillclimb_out], hint))
    return sorted(todo, key=lambda j: -j[2])


def run(args):
    out = args.out
    logs = os.path.join(out, "logs")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    queue = jobs(out, args.hillclimb, args.hillclimb_out)
    info = {"cpu": cpu_model(), "cores": os.cpu_count(), "jobs": args.jobs,
            "card": card(), "started": time.strftime("%Y-%m-%d %H:%M:%S"),
            "runs": []}
    print(f"[batch] {len(queue)} processes, at most {args.jobs} at once; "
          f"host {info['cpu']}, {info['cores']} cores; card {info['card']}",
          flush=True)
    running = {}                # pid → (name, argv, t0, most at once, log)
    t_start = time.time()
    while queue or running:
        while queue and len(running) < args.jobs:
            name, argv, _ = queue.pop(0)
            log = open(os.path.join(logs, name + ".log"), "w")
            proc = subprocess.Popen([sys.executable] + argv, cwd=REPO,
                                    env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
            running[proc.pid] = [name, argv, time.time(), 0, log, proc]
            for r in running.values():
                r[3] = max(r[3], len(running))
            print(f"[batch] +{time.time() - t_start:7.1f}s start {name} "
                  f"({len(running)} running)", flush=True)
        pid, status, ru = os.wait4(-1, os.WNOHANG)
        if pid == 0:
            time.sleep(0.2)
            for p, r in running.items():
                if args.timeout and time.time() - r[2] > args.timeout:
                    os.kill(p, signal.SIGKILL)   # reaped by wait4 above
            continue
        name, argv, t0, most, log, _ = running.pop(pid)
        log.close()
        rc = os.waitstatus_to_exitcode(status)
        rec = {"name": name, "argv": argv, "wall_s": round(time.time() - t0,
                                                           1),
               "rc": rc, "most_at_once": most,
               "maxrss_gb": round(ru.ru_maxrss / 1e6, 2)}
        info["runs"].append(rec)
        print(f"[batch] +{time.time() - t_start:7.1f}s done {name}: rc {rc}, "
              f"{rec['wall_s']} s, {most} at once, {rec['maxrss_gb']} GB",
              flush=True)
        info["wall_s"] = round(time.time() - t_start, 1)
        with open(os.path.join(out, f"batch_{args.tag}.json"), "w") as f:
            json.dump(info, f, indent=1)
    bad = [r["name"] for r in info["runs"] if r["rc"] != 0]
    print(f"[batch] {len(info['runs'])} processes in {time.time() - t_start:.1f}"
          f" s; nonzero exit: {bad}", flush=True)
    return 1 if bad else 0


def table(args):
    """One markdown row an (arch, shape): on each grid its status and
    ``elapsed_s`` with the processes at once (a record this script did
    not run shows its wall alone), the corrected FLOPs and bytes, the
    argument GB a device and one controller's peak GB; then the
    hillclimb's records."""
    runs = {}
    for path in sorted(glob.glob(os.path.join(args.out, "batch_*.json"))):
        with open(path) as f:
            for r in json.load(f)["runs"]:
                runs[r["name"]] = r
    print("| Pair | (16, 16): status, s (at once) | FLOPs | bytes | arg GB "
          "| peak GB | (2, 16, 16): status, s (at once) | FLOPs | arg GB | "
          "peak GB |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    n_ok = n = 0
    for arch in ASSIGNED:
        for shape in INPUT_SHAPES:
            cells = []
            for grid in GRIDS:
                name = key(arch, shape, grid)
                path = os.path.join(args.out, name + ".json")
                n += 1
                if not os.path.exists(path):
                    cells.append(["no record", "", "", "", ""])
                    continue
                with open(path) as f:
                    rec = json.load(f)
                n_ok += rec["status"] == "ok"
                full, corr = rec.get("full", {}), rec.get("corrected", {})
                at = runs.get(name, {}).get("most_at_once")
                sc = " scaled" if rec.get("meta", {}).get("scaled") else ""
                cells.append([
                    f"{rec['status']}{sc}, {rec.get('elapsed_s', '')}"
                    + (f" ({at})" if at else ""),
                    f"{corr.get('flops', 0):.4e}",
                    f"{corr.get('bytes', 0):.4e}",
                    f"{full.get('arg_bytes', 0) / 1e9:.3f}",
                    f"{full.get('peak_bytes', 0) / 1e9:.1f}"])
            a, b = cells
            print(f"| {arch} {shape} | {a[0]} | {a[1]} | {a[2]} | {a[3]} | "
                  f"{a[4]} | {b[0]} | {b[1]} | {b[3]} | {b[4]} |")
    print(f"\n{n_ok} ok of {n}")
    for path in sorted(glob.glob(os.path.join(args.hillclimb_out,
                                              "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        c, full = rec.get("corrected", {}), rec.get("full", {})
        print(f"hillclimb {os.path.basename(path)[:-5]}: {rec['status']}, "
              f"{rec.get('elapsed_s', '')} s, flops {c.get('flops', 0):.4e},"
              f" bytes {c.get('bytes', 0):.4e}, args "
              f"{full.get('arg_bytes', 0) / 1e9:.3f} GB a device, peak "
              f"{full.get('peak_bytes', 0) / 1e9:.1f} GB")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    ap.add_argument("--hillclimb", action="store_true")
    ap.add_argument("--hillclimb-out", default=HILLCLIMB_OUT)
    ap.add_argument("--timeout", type=float, default=0,
                    help="kill a process after this many seconds (0: none)")
    ap.add_argument("--tag", default=time.strftime("%Y%m%d_%H%M%S"),
                    help="names this run's batch_<tag>.json")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args(argv)
    if args.table:
        return table(args)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
