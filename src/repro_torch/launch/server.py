"""Open-loop serving launcher — the MemoServer runtime (DESIGN.md §2.7),
the counterpart of the reference's ``launch/server.py``.

    python -m repro_torch.launch.server --requests 96        # on the card
    python -m repro_torch.launch.server --device cpu --maintenance sync

Generates a Poisson-arrival request stream with variable lengths and a
mid-run corpus drift (new clause skeletons), serves it through the
length-bucketed continuous-batching runtime, and reports open-loop
throughput + p50/p99 latency. With ``--maintenance both`` (default) the
same trace is served twice — synchronous batch-boundary maintenance vs
the off-thread worker — on identically rebuilt sessions, isolating the
compute/maintenance overlap that the async runtime buys. ``--fault``
runs a warm → fault → recover trace instead, narrating the health
ladder.

``--capacity-dir ROOT`` attaches the capacity (disk) tier: each session
the run builds gets its own directory under ROOT (``probe``, ``sync``,
``async``, ``fault``), checkpointed after every applied payload, and
left there for ``MemoSession.load(<dir>, ...)``. The disk chaos classes
(``--fault disk_write_io`` and the other ``capacity.*`` presets) need a
tier: without ``--capacity-dir`` they serve over a temporary directory,
removed at the end.

The model is the architecture's reduced config (``--arch``: any of the
zoo's decoders and encoders, the hybrid recurrentgemma_2b among them;
not whisper_medium, whose batches need frames). ``--codec``, ``--index``
and ``--device-index`` serve every codec and index of the package.
``--shards N`` serves through the sharded device store
(``core/shard.py``) over N of the local cards, clamped to their count (1
on the CPU). Memoized prefill is served by ``launch/serve.py --prefill``, as in
the reference, whose ``server.py`` has no such option.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.device import resolve_device
from repro_torch.memo import CHAOS_PRESETS, LEVELS, MemoSession, MemoSpec
from repro_torch.models import build_model


def make_workload(corpora, n_requests: int, rate: float, buckets,
                  seed: int = 0):
    """Poisson arrivals at ``rate`` req/s; each request picks a bucket,
    draws a length just under it (several distinct lengths per bucket, so
    the length-gated store must adapt per length), and takes its tokens
    from the corpus phase active at that point in the stream — the drift
    that keeps admission/eviction/recal busy."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), n_requests)
    arrivals = np.cumsum(gaps)
    per_phase = max(1, n_requests // len(corpora))
    wl = []
    for i in range(n_requests):
        corpus = corpora[min(i // per_phase, len(corpora) - 1)]
        bucket = int(rng.choice(buckets))
        length = bucket - int(rng.integers(0, max(1, bucket // 8)))
        toks = corpus.sample(1, rng)[0][0, :length]
        wl.append((float(arrivals[i]), toks))
    return wl


def capacity_dir_for(args, leg: str):
    """The capacity-tier directory of one session the run builds:
    ``<--capacity-dir>/<leg>``, or a fresh temporary directory when a
    disk chaos class needs a tier and none was given (``None`` when
    neither)."""
    if args.capacity_dir:
        return os.path.join(args.capacity_dir, leg)
    fault = getattr(args, "fault", None)
    if fault and any(p.startswith("capacity.")
                     for p in CHAOS_PRESETS.get(fault, {})):
        return tempfile.mkdtemp(prefix="memo_fault_capacity_")
    return None


def release_session(args, sess) -> None:
    """Close a session's capacity tier (checkpoint, unlock) and remove its
    directory when the run made it as a temporary one."""
    store = sess.store
    if store.capacity is not None:
        store.checkpoint()
        store.capacity.close()
    d = sess.spec.capacity.dir
    if d and not args.capacity_dir:
        shutil.rmtree(d, ignore_errors=True)


def build_session(args, seed: int = 0, cfg=None, leg: str = "serve"):
    """A freshly built session per A/B leg: both legs must start from the
    identical calibration store (serving mutates it). ``cfg`` replaces
    the reduced config of ``args.arch`` (a full-width config, say);
    ``leg`` names the session's capacity-tier directory
    (``capacity_dir_for``)."""
    fault = getattr(args, "fault", None)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_reduced(args.arch)
    if cfg.encoder is not None:
        raise ValueError(
            f"{cfg.name!r} is an encoder-decoder model: its requests need "
            f"frames, which the trace does not make")
    if not cfg.n_classes:
        cfg = cfg.replace(n_classes=4)
    model = build_model(cfg, device=device)
    params = model.init(seed)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=args.seq, seed=1)
    thr = args.threshold if args.threshold is not None else LEVELS.get(
        args.level, 0.97)
    spec = MemoSpec.flat(
        threshold=thr, mode="bucket", apm_codec=args.codec,
        admit=True, budget_mb=args.budget_mb,
        admit_every=args.admit_every, recal_every=2,
        device_slack=args.device_slack, embed_steps=args.embed_steps,
        index_kind=args.index, device_index=args.device_index,
        capacity_dir=capacity_dir_for(args, leg),
        capacity_checkpoint_every=1, shards=args.shards,
        faults=({} if fault else None))
    calib = [{"tokens": corpus.sample(args.batch)[0]}
             for _ in range(args.calib_batches)]
    sess = MemoSession.build(model, params, spec, batches=calib, seed=1,
                             device=device)
    if args.threshold is None and args.level in LEVELS:
        sess.autotune([{"tokens": corpus.sample(args.batch)[0]}],
                      level=args.level)
    return sess, corpus


def probe_rate(sess: MemoSession, *, buckets, max_batch: int, seq: int,
               utilization: float = 0.7) -> float:
    """Size the open loop near (below) capacity by timing one warm batch
    at the REAL sync-mode serving cost — miss capture + inline admission
    + delta sync included (excluding maintenance overstates capacity and
    the trace saturates the queue), so the loaded-but-stable regime
    surfaces maintenance stalls in the latency tail.

    The probe therefore MUTATES the store (its misses are admitted):
    callers comparing A/B legs must probe a throwaway session or rebuild
    after probing."""
    eng = sess.engine
    server = sess.serve(buckets=tuple(buckets),
                        max_batch=max_batch, async_maintenance=False)
    server.warmup()
    # two all-miss batches (fresh random tokens each round, so round 2
    # cannot hit round 1's admissions): the first pays the first-call
    # costs of the maintenance path warmup() does not cover; only the
    # second reflects the steady serve + maintenance cost
    rng = np.random.default_rng(0)
    dt = 0.0
    for _ in range(2):
        toks = rng.integers(1, eng.cfg.vocab,
                            (max_batch, seq)).astype(np.int32)
        t0 = time.perf_counter()
        for i in range(max_batch):
            server.submit(toks[i, : seq - 1])
        server.step(flush=True)
        dt = time.perf_counter() - t0
    server.close()
    return utilization * max_batch / max(dt, 1e-6)


def serve_trace(sess: MemoSession, workload, *, buckets, max_batch: int,
                max_delay: float, async_maintenance: bool):
    """Serve one open-loop trace and summarize it — the shared A/B leg.
    Beside the summary it returns the closed ``server`` and its
    ``completions`` for callers that check them."""
    server = sess.serve(buckets=tuple(buckets), max_batch=max_batch,
                        max_delay=max_delay,
                        async_maintenance=async_maintenance)
    server.warmup()
    t0 = time.perf_counter()
    with server:
        comps = server.run(workload)
    wall = time.perf_counter() - t0
    lats = np.asarray([c.latency for c in comps]) * 1e3
    st = server.stats
    return {
        "n_requests": len(comps),
        "throughput_rps": float(len(comps) / wall),
        "p50_ms": float(np.percentile(lats, 50)),
        "p99_ms": float(np.percentile(lats, 99)),
        "mean_ms": float(lats.mean()),
        "hit_rate": float(st.memo_rate),
        "n_admitted": int(st.n_admitted),
        "n_batches": int(server.n_batches),
        "filler_rows": int(server.n_filler_rows),
        "server": server,
        "completions": comps,
    }


def run_fault_demo(args):
    """``--fault <class>``: one warm → fault → recover trace through the
    supervised runtime, narrating the health ladder (DESIGN.md §2.9)."""
    try:
        preset = CHAOS_PRESETS[args.fault]
    except KeyError:
        raise SystemExit(
            f"unknown chaos class {args.fault!r}; known classes: "
            f"{sorted(CHAOS_PRESETS)}") from None
    rate = args.rate
    if rate is None:
        sess, corpus = build_session(args, leg="probe")
        rate = probe_rate(sess, buckets=args.bucket_list,
                          max_batch=args.batch, seq=args.seq)
        release_session(args, sess)         # the probe mutated the store
    sess, corpus = build_session(args, leg="fault")
    inj = sess.engine.faults
    n = max(3, args.requests // 3)
    server = sess.serve(buckets=args.bucket_list, max_batch=args.batch,
                        max_delay=args.max_delay_ms * 1e-3,
                        async_maintenance=True)
    server.warmup()
    print(f"[server] chaos class {args.fault!r}: arming {preset} "
          f"for the middle third of {3 * n} requests "
          f"(Poisson {rate:.1f} req/s)")
    logged = 0

    def flush_health():
        # health_log is a BOUNDED ring: diff against the transition
        # counter, not the log length, so narration survives wraparound
        nonlocal logged
        log = list(server.health_log)
        fresh = server.n_health_transitions - logged
        if fresh > len(log):
            print(f"[health] ... {fresh - len(log)} transition(s) "
                  f"aged out of the ring ...")
        for t, health, why in log[max(0, len(log) - fresh):]:
            print(f"[health] t={t:7.3f}s  -> {health}: {why}")
        logged = server.n_health_transitions

    completed = 0
    with server:
        for phase, armed in (("warm", False), ("fault", True),
                             ("recovered", False)):
            if armed:
                for point, kw in preset.items():
                    inj.arm(point, **kw)
            elif phase == "recovered":
                # the fault phase's payloads are applied while the fault
                # is still armed, then it is disarmed and recovered from
                try:
                    server.drain_maintenance(timeout=10,
                                             raise_errors=False)
                except (TimeoutError, RuntimeError) as e:
                    # a stalled or dead worker: recover() restarts it
                    print(f"[server] drain before recover(): {e}")
                inj.disarm()
                info = server.recover()
                print(f"[server] recover(): {info}")
            # the fault phase serves fresh requests (misses to admit and
            # write through under the fault); the recovered phase replays
            # the warm one
            comps = server.run(make_workload([corpus], n, rate,
                                             args.bucket_list,
                                             seed=8 if armed else 7))
            completed += len(comps)
            flush_health()
            print(f"[server] {phase:9s}: {len(comps)}/{n} completed, "
                  f"health {server.health.value}, "
                  f"hit {server.stats.memo_rate * 100:.1f}% (cumulative)")
        server.drain_maintenance(timeout=30, raise_errors=False)
        flush_health()
    print(f"[server] chaos done: {completed}/{3 * n} requests served, "
          f"shed {server.n_maint_shed}, retries {server.n_maint_retries}, "
          f"exact batches {server.n_exact_batches}, "
          f"quarantined {sess.store.stats.n_quarantined}, "
          f"final health {server.health.value}")
    tail = list(server.health_log)[-5:]
    print(f"[server] last {len(tail)} of {server.n_health_transitions} "
          f"health transition(s):")
    for t, health, why in tail:
        print(f"[server]   t={t:7.3f}s  -> {health}: {why}")
    store = sess.store
    disk = None
    if sess.spec.capacity.dir:
        disk = {"capacity_ok": store.capacity_ok,
                "checkpoints": server.n_checkpoints,
                "disk_errors": store.stats.n_disk_errors,
                "demoted": store.stats.n_demoted,
                "promoted": store.stats.n_promoted}
        print(f"[server] capacity tier: {disk}")
    release_session(args, sess)
    return {"completed": completed, "requests": 3 * n,
            "health": server.health.value, "shed": server.n_maint_shed,
            "exact_batches": server.n_exact_batches, "capacity": disk}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert_base",
                    help="an architecture of repro_torch.configs, served "
                         "at its reduced config (not whisper_medium, "
                         "whose requests need frames)")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="(always on — this launcher serves reduced "
                         "configs; kept for arg parity with launch.serve)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrival rate, req/s (default: sized to "
                         "~70%% of measured serve capacity)")
    ap.add_argument("--batch", type=int, default=8,
                    help="max batch per bucket (also calibration batch)")
    ap.add_argument("--seq", type=int, default=48,
                    help="max sequence length (largest bucket)")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated length buckets (default: "
                         "seq/2, seq)")
    ap.add_argument("--max-delay-ms", type=float, default=4.0)
    ap.add_argument("--level", default="aggressive", choices=list(LEVELS))
    ap.add_argument("--threshold", type=float, default=None)
    ap.add_argument("--codec", default="int8",
                    choices=["f16", "int8", "lowrank"])
    ap.add_argument("--budget-mb", type=float, default=256.0)
    ap.add_argument("--admit-every", type=int, default=1)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--embed-steps", type=int, default=120)
    ap.add_argument("--device-slack", type=float, default=8.0,
                    help="device-arena slack for delta syncs")
    ap.add_argument("--index", default="exact",
                    choices=["exact", "ivf", "device"],
                    help="host index")
    ap.add_argument("--device-index", default="auto",
                    choices=["auto", "flat", "clustered"],
                    help="device index (auto: clustered from "
                         "4096 entries on)")
    ap.add_argument("--capacity-dir", default=None,
                    help="root of the capacity (disk) tier directories, "
                         "one per session the run builds")
    ap.add_argument("--shards", type=int, default=0,
                    help="partition the device memo store over N "
                         "shards, one a local card (0 = single-device "
                         "store; clamped to the card count, 1 on the "
                         "CPU)")
    ap.add_argument("--phases", type=int, default=2,
                    help="corpus drift phases across the trace")
    ap.add_argument("--maintenance", default="both",
                    choices=["both", "sync", "async"])
    ap.add_argument("--fault", default=None,
                    choices=sorted(CHAOS_PRESETS),
                    help="chaos demo: serve warm, arm this fault class "
                         "mid-trace, recover(), printing every health "
                         "transition (DESIGN.md §2.9)")
    args = ap.parse_args(argv)
    args.bucket_list = (tuple(int(b) for b in args.buckets.split(","))
                        if args.buckets else (args.seq // 2, args.seq))
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.fault:
        return run_fault_demo(args)

    results = {}
    modes = (["sync", "async"] if args.maintenance == "both"
             else [args.maintenance])
    workload = None
    for mode in modes:
        sess, corpus = build_session(args, leg=mode)
        if workload is None:
            phases = [corpus] + [
                TemplateCorpus(vocab=sess.engine.cfg.vocab,
                               seq_len=args.seq,
                               seed=100 + 17 * i,
                               n_templates=corpus.n_templates,
                               slot_fraction=corpus.slot_fraction)
                for i in range(1, args.phases)]
            rate = args.rate
            if rate is None:
                probe, _ = build_session(args, leg="probe")
                rate = probe_rate(probe, buckets=args.bucket_list,
                                  max_batch=args.batch, seq=args.seq)
                # the probe admitted its misses: it serves on its own
                # session so that every A/B leg starts from the
                # identical calibration store
                release_session(args, probe)
            workload = make_workload(phases, args.requests, rate,
                                     args.bucket_list, seed=7)
            print(f"[server] {args.requests} requests, Poisson "
                  f"{rate:.1f} req/s, buckets {args.bucket_list}, "
                  f"max_batch {args.batch}, drift phases {args.phases}, "
                  f"device {sess.engine.device}")
        r = serve_trace(sess, workload, buckets=args.bucket_list,
                        max_batch=args.batch,
                        max_delay=args.max_delay_ms * 1e-3,
                        async_maintenance=(mode == "async"))
        r.pop("server"), r.pop("completions")
        release_session(args, sess)
        results[mode] = r
        print(f"[server] {mode:5s} maintenance: "
              f"{r['throughput_rps']:6.1f} req/s  "
              f"p50 {r['p50_ms']:7.1f} ms  p99 {r['p99_ms']:7.1f} ms  "
              f"hit {r['hit_rate']*100:5.1f}%  "
              f"admitted {r['n_admitted']}  batches {r['n_batches']}")
    if len(results) == 2:
        s, a = results["sync"], results["async"]
        print(f"[server] async vs sync: p99 {a['p99_ms']/s['p99_ms']:.2f}x"
              f"  p50 {a['p50_ms']/s['p50_ms']:.2f}x  "
              f"(hit rate {a['hit_rate']*100:.1f}% vs "
              f"{s['hit_rate']*100:.1f}%)")
    return results


if __name__ == "__main__":
    main()
