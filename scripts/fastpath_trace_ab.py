"""Kernel-mode batches of chip_smoke's bert_base session, traced and
untraced, for one checkout of the repo or several side by side.

    python3 scripts/fastpath_trace_ab.py [--reps N] ROOT [ROOT ...]

Each ROOT is a checkout (its ``chip_smoke.py`` and ``src/``), run in a
process of its own in the order given: to compare two commits in one
call give parent, change, change, parent. Each process builds ROOT's
kernels, serves chip_smoke's phase-3 session (``serve_main_path``: 12
layers, d_model 768, seq 128, batch 32), then serves its first request
in kernel mode ``N`` times without the profiler (host clock around
``infer`` and a synchronize) and ``N`` times each under its own
``torch.profiler`` trace: wall, device busy (the sum of kernel time on
the one stream), idle share, and the host-side operator events the
trace recorded. One JSON line per ROOT. Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def child(root: str, reps: int, device: str = "cuda") -> dict:
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_info()
    dev = torch.device(device)
    sess, _, _, main = cs.serve_main_path(torch, dev)
    # chip_smoke returns the phase-3 requests, or (before they were
    # returned) the first request itself
    batch = main["requests"][0] if "requests" in main else main
    sess.spec.runtime.mode = "kernel"
    for _ in range(2):
        sess.infer(batch)
    torch.cuda.synchronize()

    plain = []
    for _ in range(reps):
        t = time.perf_counter()
        sess.infer(batch)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t) * 1e3)

    traced = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            sess.infer(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy, cpu_events, cpu_ms = 0.0, 0, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                busy += getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
            else:
                cpu_events += e.count
                cpu_ms[e.key] = (e.self_cpu_time_total / 1e3, e.count)
        traced.append(dict(wall_ms=wall, busy_ms=busy / 1e3,
                           idle=1 - busy / 1e3 / wall,
                           cpu_events=cpu_events))
    top = sorted(cpu_ms.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        root=root, plain_ms=plain, plain_median_ms=_median(plain),
        traced=traced,
        traced_median=dict(
            wall_ms=_median([t["wall_ms"] for t in traced]),
            busy_ms=_median([t["busy_ms"] for t in traced]),
            idle=_median([t["idle"] for t in traced])),
        last_trace_top_host_ops=[
            dict(op=k[:60], self_cpu_ms=v[0], count=v[1])
            for k, v in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child, args.reps)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("fastpath_trace_ab: no CUDA device", file=sys.stderr)
        return 2
    rc = 0
    for i, root in enumerate(args.roots):
        p = subprocess.run([sys.executable, __file__, "--reps",
                            str(args.reps), "--child",
                            os.path.abspath(root)],
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode or not lines:
            print(f"run {i + 1} {root}: rc {p.returncode}\n"
                  f"{p.stderr[-4000:]}", file=sys.stderr)
            rc = 1
            continue
        res = json.loads(lines[-1][len("RESULT "):])
        res["run"] = i + 1
        print(json.dumps(res))
    return rc


if __name__ == "__main__":
    sys.exit(main())
