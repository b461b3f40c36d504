#!/usr/bin/env python3
"""Every (arch × shape × grid) pair of the dry run, and the hillclimb, in
batches on one host: one process a pair, never more at once than
``--jobs`` (the host's cores by default), the costliest first.

    python3 scripts/dryrun_batch.py [--jobs 8] [--hillclimb] [--timeout S]
                                    [--until S]
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
# seconds each pair takes on an 8-core host running 8 pairs at once, one
# device's count and the whole step's (the batch's order only; a pair
# not listed takes seconds): one controller's walk alone, measured with
# PR 29's code, times ~2.5 for the two counts; a SCALED pair's 1- and
# 2-unit walks
COST_HINT = {
    ("kimi_k2_1t_a32b", "prefill_32k", "pod512"): 2600,
    ("kimi_k2_1t_a32b", "prefill_32k", "pod256"): 1400,
    ("dbrx_132b", "prefill_32k", "pod512"): 900,
    ("kimi_k2_1t_a32b", "decode_32k", "pod256"): 760,
    ("kimi_k2_1t_a32b", "decode_32k", "pod512"): 710,
    ("recurrentgemma_2b", "train_4k", "pod256"): 690,
    ("kimi_k2_1t_a32b", "train_4k", "pod256"): 600,     # scaled
    ("kimi_k2_1t_a32b", "train_4k", "pod512"): 600,     # scaled
    ("dbrx_132b", "prefill_32k", "pod256"): 520,
    ("recurrentgemma_2b", "prefill_32k", "pod256"): 490,
    ("dbrx_132b", "decode_32k", "pod512"): 480,
    ("recurrentgemma_2b", "train_4k", "pod512"): 460,
    ("dbrx_132b", "decode_32k", "pod256"): 420,
    ("rwkv6_3b", "prefill_32k", "pod256"): 400,         # scaled
    ("rwkv6_3b", "prefill_32k", "pod512"): 400,         # scaled
    ("rwkv6_3b", "train_4k", "pod256"): 350,            # scaled
    ("rwkv6_3b", "train_4k", "pod512"): 350,            # scaled
    ("dbrx_132b", "train_4k", "pod256"): 300,           # scaled
    ("dbrx_132b", "train_4k", "pod512"): 300,           # scaled
    ("recurrentgemma_2b", "prefill_32k", "pod512"): 310,
}
HILLCLIMB_HINT = {1: 200, 2: 1400, 3: 200}


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
    """(name, argv, hint) of every pair without a record in ``out`` and
    the hillclimb's pairs: the single-pod pairs and the hillclimb first,
    then the multi-pod pairs, each costliest first."""
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
    return sorted(todo, key=lambda j: (j[0].endswith("pod512"), -j[2]))


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
        if args.until and time.time() - t_start > args.until:
            queue = []
            for p in running:
                os.kill(p, signal.SIGKILL)      # reaped by wait4 below
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
    """One markdown row an (arch, shape): on (16, 16) its status and
    ``elapsed_s`` with the processes at once (a record this script did
    not run shows its wall alone), one device's corrected FLOPs, its
    collective GB, argument GB and peak GB, and the whole step's FLOPs
    and peak GB on one controller; on (2, 16, 16) its status alone.
    Then the hillclimb's records, and the ops that ran replicated."""
    runs = {}
    for path in sorted(glob.glob(os.path.join(args.out, "batch_*.json"))):
        with open(path) as f:
            for r in json.load(f)["runs"]:
                runs[r["name"]] = r
    print("| Pair | (16, 16): status, s (at once) | FLOPs a device | "
          "collective GB a device | arg GB | peak GB a device | whole FLOPs "
          "| whole peak GB | (2, 16, 16): status, s (at once) |")
    print("|---|---|---|---|---|---|---|---|---|")
    n_ok = n = 0
    fallbacks = {}
    for arch in ASSIGNED:
        for shape in INPUT_SHAPES:
            cells = []
            for grid in GRIDS:
                name = key(arch, shape, grid)
                path = os.path.join(args.out, name + ".json")
                n += 1
                if not os.path.exists(path):
                    cells.append(["no record"] + [""] * 6)
                    continue
                with open(path) as f:
                    rec = json.load(f)
                n_ok += rec["status"] == "ok"
                for op in rec.get("fallbacks", {}):
                    fallbacks.setdefault(op, []).append(name)
                full, corr = rec.get("full", {}), rec.get("corrected", {})
                whole = rec.get("whole", {})
                at = runs.get(name, {}).get("most_at_once")
                sc = " scaled" if rec.get("meta", {}).get("scaled") else ""
                cells.append([
                    f"{rec['status']}{sc}, {rec.get('elapsed_s', '')}"
                    + (f" ({at})" if at else ""),
                    f"{corr.get('flops', 0):.4e}",
                    f"{corr.get('collective_bytes', 0) / 1e9:.3f}",
                    f"{full.get('arg_bytes', 0) / 1e9:.3f}",
                    f"{full.get('peak_bytes', 0) / 1e9:.2f}",
                    f"{whole.get('flops', 0):.4e}",
                    f"{whole.get('peak_bytes', 0) / 1e9:.1f}"])
            a, b = cells
            print(f"| {arch} {shape} | " + " | ".join(a) + f" | {b[0]} |")
    print(f"\n{n_ok} ok of {n}")
    for path in sorted(glob.glob(os.path.join(args.hillclimb_out,
                                              "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        c, full = rec.get("corrected", {}), rec.get("full", {})
        whole = rec.get("whole", {})
        for op in rec.get("fallbacks", {}):
            fallbacks.setdefault(op, []).append(os.path.basename(path)[:-5])
        print(f"hillclimb {os.path.basename(path)[:-5]}: {rec['status']}, "
              f"{rec.get('elapsed_s', '')} s, flops a device "
              f"{c.get('flops', 0):.4e}, collectives a device "
              f"{c.get('collective_bytes', 0) / 1e9:.4f} GB, args "
              f"{full.get('arg_bytes', 0) / 1e9:.3f} GB, peak "
              f"{full.get('peak_bytes', 0) / 1e9:.2f} GB a device; whole "
              f"flops {whole.get('flops', 0):.4e}, peak "
              f"{whole.get('peak_bytes', 0) / 1e9:.1f} GB")
    for op, names in sorted(fallbacks.items()):
        print(f"replicated {op}: {len(names)} records: {', '.join(names)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    ap.add_argument("--hillclimb", action="store_true")
    ap.add_argument("--until", type=float, default=0,
                    help="start no process after this many seconds of "
                         "the batch and kill those still running then "
                         "(0: no limit)")
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
