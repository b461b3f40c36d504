"""Serving launcher: batched request loop with optional AttMemo
memoization — the counterpart of the reference's ``launch/serve.py``.

    python -m repro_torch.launch.serve --arch bert_base --requests 64
    python -m repro_torch.launch.serve --arch gpt2_small --no-memo
    python -m repro_torch.launch.serve --arch bert_base --online
    python -m repro_torch.launch.serve --arch gpt2_small --prefill
    python -m repro_torch.launch.serve --device cpu --requests 16 \\
        --batch 4 --seq 16 --calib-batches 2

The model is the architecture's reduced config (``--arch``: any of the
zoo's decoders and encoders, the hybrid recurrentgemma_2b among them),
on the card unless ``--device cpu`` is passed (it raises when there is
no card). whisper_medium's batches need frames, which this launcher, like
the reference's, does not make: it is refused. Every option of the
reference is here with its name and default:

* the default leg serves ``--requests`` in batches of ``--batch``, each
  batch memo-free and memoized, and reports latency and the hit rate
  (``--no-memo``, ``--no-fast-path`` for the host-synchronous path,
  ``--varlen`` for padded variable-length batches and their select
  parity, ``--selective`` for the profiler's active layers);
* ``--online`` demonstrates the store's lifecycle under drifting
  traffic: a frozen pass, then an adaptive one with admission, delta
  sync and recalibration (without ``--ckpt`` it first trains the
  classifier head for 50 steps);
* ``--prefill`` (a causal arch, e.g. ``--arch gpt2_small``) is the
  memoized-prefill A/B: exact against memoized prefill per batch, then a
  replayed calibration batch decoded greedily from both cache sets;
* ``--save-store`` / ``--load-store`` persist and warm-start a session
  (files cross between the packages), ``--ckpt`` loads weights written
  by either package's ``train/checkpoint.py``: a checkpoint whose meta
  names the arch's full config (``launch/train.py`` without
  ``--reduced``) is served at that config.

``--shards N`` serves through the sharded device store (``core/shard.py``)
over N of the local cards, clamped to their count (1 on the CPU), and
prints a ``[serve] shards`` line with the per-shard occupancy.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.device import resolve_device, synchronize
from repro_torch.memo import LEVELS, MemoSession, MemoSpec, MemoStats
from repro_torch.models import build_model
from repro_torch.train.checkpoint import load_checkpoint


def _autotune_threshold(eng, corpus, args, tag):
    """Paper Table 2 levels are per-model: autotune from a FRESH sample
    of the calibration distribution (percentiles of the predicted top-1
    similarity); the calibration batches themselves would give
    zero-distance percentiles."""
    levels = eng.suggest_levels([{"tokens": corpus.sample(args.batch)[0]}])
    eng.mc.threshold = levels.get(args.level, eng.mc.threshold)
    print(f"[{tag}] autotuned threshold ({args.level}): "
          f"{eng.mc.threshold:.3f}")


def _run_phase(eng, corpus, n_batches, batch_size, st):
    """Serve one phase; returns (per-batch hit rates, ms/batch, stats)."""
    rates, times = [], []
    for _ in range(n_batches):
        toks = corpus.sample(batch_size)[0]
        h0, a0 = st.n_hits, st.n_layer_attempts
        t0 = time.perf_counter()
        _, st = eng.infer({"tokens": toks}, stats=st)
        synchronize(eng.device)
        times.append((time.perf_counter() - t0) * 1e3)
        rates.append((st.n_hits - h0) / max(1, st.n_layer_attempts - a0))
    return rates, times, st


@torch.no_grad()
def _serve_prefill(eng, model, corpus, args, calib):
    """Prefill-memoization A/B: per batch, time exact prefill against
    memoized prefill, then decode greedily from both cache sets of a
    replayed calibration batch and report parity."""
    st = MemoStats()
    lat_memo, lat_exact = [], []
    n_batches = max(1, args.requests // args.batch)
    for _ in range(n_batches):
        batch = {"tokens": corpus.sample(args.batch)[0]}
        t0 = time.perf_counter()
        eng.prefill_exact(batch)
        synchronize(eng.device)
        lat_exact.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, _, st = eng.prefill(batch, stats=st)
        synchronize(eng.device)
        lat_memo.append(time.perf_counter() - t0)

    p = np.median(lat_exact[1:] or lat_exact) * 1e3
    m = np.median(lat_memo[1:] or lat_memo) * 1e3
    print(f"[prefill] exact        {p:8.1f} ms/batch")
    print(f"[prefill] memoized     {m:8.1f} ms/batch  "
          f"({(1 - m / p) * 100:+.1f}% latency)")
    print(f"[prefill] memo rate    {st.memo_rate*100:8.1f}%  "
          f"(hits {st.n_hits}/{st.n_layer_attempts})")

    # decode parity on a replay of an admitted calibration batch: on a
    # hit the decode cache comes from the stored K/V, so the gap is the
    # codec's quantization. Both legs are fed the exact leg's tokens
    # (teacher forcing) so one divergent step cannot snowball; agreement
    # counts how often the memoized leg would have picked the same token
    replay = calib[0]
    h0, a0 = st.n_hits, st.n_layer_attempts
    le, ce = eng.prefill_exact(replay)
    lm, cm, st = eng.prefill(replay, stats=st)
    print(f"[prefill] replay hits  {st.n_hits - h0}"
          f"/{st.n_layer_attempts - a0}")
    dmax = torch.zeros((), device=eng.device)
    agree = torch.zeros((), dtype=torch.int64, device=eng.device)
    total = 0
    synchronize(eng.device)
    t0 = time.perf_counter()
    for step in range(args.decode_steps):
        tm = lm.argmax(-1).reshape(-1)
        te = le.argmax(-1).reshape(-1)
        agree += (tm == te).sum()
        total += int(te.shape[0])
        pos = args.seq + step
        lm, cm = model.decode_step(eng.params, te[:, None], cm, pos)
        le, ce = model.decode_step(eng.params, te[:, None], ce, pos)
        dmax = torch.maximum(dmax, (lm - le).abs().max())
    synchronize(eng.device)
    dt = time.perf_counter() - t0
    print(f"[prefill] decode       {args.decode_steps} steps x "
          f"{args.batch} rows in {dt*1e3:.1f} ms "
          f"({args.decode_steps * args.batch / dt:.0f} tok/s)")
    print(f"[prefill] parity       max|Δlogits| {float(dmax):.2e}, greedy "
          f"agreement {int(agree)}/{total}")
    return dict(hits=st.n_hits, attempts=st.n_layer_attempts,
                max_dlogits=float(dmax), agree=int(agree), total=total)


@torch.no_grad()
def _serve_online(eng, corpus, args):
    """Drift-phase schedule: phase 0 = the calibration distribution, later
    phases = drifted corpora. Frozen pass first (store untouched), then
    the adaptive pass with admission + delta sync."""
    def mk(seed):
        return TemplateCorpus(vocab=eng.cfg.vocab, seq_len=args.seq,
                              seed=seed, n_templates=corpus.n_templates,
                              slot_fraction=corpus.slot_fraction)
    phases = [corpus] + [mk(100 + 17 * i) for i in range(1, args.phases)]
    results = {}
    counts0 = eng.db.reuse_counts.copy()
    for label, admit in (("frozen", False), ("adaptive", True)):
        eng.mc.admit = admit
        # identical starting state for both passes: the frozen pass does
        # not admit or evict, but serving still warms reuse_counts (the
        # eviction clock's input) — restore them
        eng.db.reuse_counts[:] = counts0
        st = MemoStats()
        per_phase = []
        for pi, ph in enumerate(phases):
            # the same requests in both passes: re-seed the phase's RNG
            ph._rng = np.random.default_rng(1000 + pi)
            rates, times, st = _run_phase(eng, ph, args.phase_batches,
                                          args.batch, st)
            per_phase.append((rates, times))
            tail = np.mean(rates[len(rates) // 2:])
            print(f"[online] {label:8s} phase {pi}: hit-rate "
                  f"{' '.join(f'{r:.2f}' for r in rates)}  "
                  f"(steady {tail:.2f})  {np.median(times):6.1f} ms/batch")
        results[label] = (per_phase, st)
    eng.mc.admit = False

    froz = results["frozen"][0][-1][0]
    adap = results["adaptive"][0][-1][0]
    froz_ss = float(np.mean(froz[len(froz) // 2:]))
    adap_ss = float(np.mean(adap[len(adap) // 2:]))
    s = eng.store.stats
    print(f"[online] post-drift steady-state hit rate: "
          f"adaptive {adap_ss:.2f} vs frozen {froz_ss:.2f} "
          f"({'∞' if froz_ss == 0 else f'{adap_ss / froz_ss:.1f}'}× recovery)")
    print(f"[online] store: {s.n_admitted} admitted, {s.n_evicted} evicted, "
          f"live {eng.store.live_count} "
          f"({eng.store.live_count * eng.store.entry_nbytes / 1e6:.1f} MB"
          + (f" / budget {eng.mc.budget_mb:.0f} MB" if eng.mc.budget_mb
             else "") + ")")
    print(f"[online] sync: {s.n_delta_syncs} delta ({s.bytes_delta/1e6:.2f} "
          f"MB) + {s.n_full_syncs} full ({s.bytes_full/1e6:.2f} MB) + "
          f"{s.n_noop_syncs} no-op; full-resync-per-batch would have moved "
          f"{(s.n_delta_syncs * len(eng.db) * eng.store.entry_nbytes)/1e6:.1f}"
          " MB")
    # logits parity against the select reference on the final drifted
    # batch (admission paused), and prediction agreement with the
    # memo-free model
    toks = phases[-1].sample(args.batch)[0]
    out_fast, _ = eng.infer({"tokens": toks})
    out_plain, _ = eng.infer({"tokens": toks}, use_memo=False)
    mode = eng.mc.mode
    eng.mc.mode = "select"
    out_sel, _ = eng.infer({"tokens": toks})
    eng.mc.mode = mode
    ok = bool(torch.allclose(out_fast, out_sel, rtol=2e-3, atol=2e-3))
    agree = float((out_fast.argmax(-1) == out_plain.argmax(-1))
                  .float().mean())
    print(f"[online] logits match select: {ok}; "
          f"prediction agreement vs no-memo: {agree:.2f}")
    return dict(frozen_rates=froz, adaptive_rates=adap, admitted=s.n_admitted,
                evicted=s.n_evicted, match_select=ok, agreement=agree)


def _train_classifier(model, params, corpus, steps: int = 50,
                     batch: int = 32):
    """A briefly trained classifier (the paper's BERT/SST-2 analogue):
    ``steps`` AdamW steps (lr 3e-4) on ``Model.classify_loss`` over the
    corpus' labels. Random-init hidden states embed poorly, which would
    understate adaptation."""
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.train.trainer import value_and_grad
    opt = adamw_init(params)
    for b in corpus.batches(steps, batch):
        _, grads = value_and_grad(model.classify_loss, params, b)
        params, opt = adamw_update(params, grads, opt, lr=3e-4)
    return params


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert_base",
                    help="an architecture of repro_torch.configs, served "
                         "at its reduced config (not whisper_medium, "
                         "whose batches need frames)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--level", default="moderate",
                    choices=list(LEVELS) + ["custom"])
    ap.add_argument("--threshold", type=float, default=None)
    ap.add_argument("--mode", default="bucket",
                    choices=["select", "bucket", "kernel"])
    ap.add_argument("--index", default="exact",
                    choices=["exact", "ivf", "device"])
    ap.add_argument("--codec", default="int8",
                    choices=["f16", "int8", "lowrank"],
                    help="APM storage codec for both memo tiers")
    ap.add_argument("--apm-rank", type=int, default=None,
                    help="lowrank codec rank (default L//8)")
    ap.add_argument("--device-index", default="auto",
                    choices=["auto", "flat", "clustered"],
                    help="device-tier search: exhaustive vs two-stage "
                         "clustered; auto flips at --cluster-crossover "
                         "entries")
    ap.add_argument("--cluster-crossover", type=int, default=4096)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--shards", type=int, default=0,
                    help="partition the device memo store over N "
                         "shards, one a local card (0 = single-device "
                         "store; clamped to the card count, 1 on the "
                         "CPU)")
    ap.add_argument("--shard-hot", type=int, default=32,
                    help="replicated hot-entry set size per shard")
    ap.add_argument("--shard-nprobe", type=int, default=None,
                    help="centroid probes per query when routing to "
                         "shards (default: the store picks)")
    ap.add_argument("--prefill", action="store_true",
                    help="memoized causal prefill: A/B latency and decode "
                         "parity against exact prefill (needs a causal "
                         "arch, e.g. --arch gpt2_small)")
    ap.add_argument("--decode-steps", type=int, default=8,
                    help="--prefill: greedy decode continuation length "
                         "for the parity check")
    ap.add_argument("--kv-codec", default="auto",
                    choices=["auto", "f16", "int8", "lowrank"],
                    help="--prefill: stored-KV codec (auto follows the "
                         "APM codec: f16 base -> f16 KV, else int8)")
    ap.add_argument("--kv-rank", type=int, default=None,
                    help="--prefill: lowrank KV codec rank")
    ap.add_argument("--no-memo", action="store_true")
    ap.add_argument("--no-fast-path", action="store_true",
                    help="force the host-synchronous serving path "
                         "(per-layer lookup round trips; A/B baseline)")
    ap.add_argument("--varlen", action="store_true",
                    help="serve variable-length padded batches and check "
                         "select parity on the last batch")
    ap.add_argument("--calib-batches", type=int, default=6)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--selective", action="store_true")
    ap.add_argument("--online", action="store_true",
                    help="drift-phase schedule with online admission "
                         "(frozen vs adaptive)")
    ap.add_argument("--phases", type=int, default=2,
                    help="--online: number of corpus phases (first = "
                         "calibration distribution)")
    ap.add_argument("--phase-batches", type=int, default=8,
                    help="--online: batches served per phase")
    ap.add_argument("--budget-mb", type=float, default=256.0,
                    help="--online: store byte budget for admission")
    ap.add_argument("--admit-every", type=int, default=1,
                    help="--online: capture misses every Nth batch")
    ap.add_argument("--save-store", default=None, metavar="PATH",
                    help="persist the built session (store + embedder + "
                         "spec) after calibration/autotune")
    ap.add_argument("--load-store", default=None, metavar="PATH",
                    help="warm-start from a saved session (either "
                         "package's) instead of calibrating")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the launcher; returns a dict of what it printed (the legs'
    hit counts among them) for callers that check it."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = None
    if args.ckpt:
        params, _, meta = load_checkpoint(args.ckpt, device=device)
        if meta.get("arch") == get_config(args.arch).name:
            # trained at the full config (launch/train.py without
            # --reduced): served at it
            cfg = get_config(args.arch)
    if cfg.encoder is not None:
        raise SystemExit(
            f"{args.arch!r} is an encoder-decoder model: its batches need "
            f"frames, which this launcher does not make; serve it through "
            f"MemoEngine.infer on {{'frames', 'tokens'}} batches")
    if args.prefill:
        if args.online or args.varlen:
            raise SystemExit("--prefill is its own serving leg; drop "
                             "--online/--varlen")
        if not cfg.causal:
            raise SystemExit(
                f"--prefill needs a causal (decoder-only) arch; "
                f"{args.arch!r} is bidirectional — try --arch gpt2_small")
    if args.online and not cfg.n_classes:
        cfg = cfg.replace(n_classes=4)
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(0)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=args.seq, seed=1)
    if args.online and not args.ckpt and cfg.n_classes:
        params = _train_classifier(model, params, corpus)
        print("[online] trained classifier head (50 steps)")

    thr = args.threshold if args.threshold is not None else LEVELS.get(
        args.level, 0.97)
    spec = MemoSpec.flat(
        threshold=thr, mode=args.mode, index_kind=args.index,
        apm_codec=args.codec, apm_rank=args.apm_rank,
        device_index=args.device_index,
        cluster_crossover=args.cluster_crossover, nprobe=args.nprobe,
        device_fast_path=False if args.no_fast_path else None,
        budget_mb=args.budget_mb if args.online else None,
        admit_every=args.admit_every,
        recal_every=2 if args.online else None,
        shards=args.shards, shard_hot=args.shard_hot,
        shard_route_nprobe=args.shard_nprobe,
        **({"prefill_enabled": True, "prefill_kv_codec": args.kv_codec,
            "prefill_kv_rank": args.kv_rank} if args.prefill else {}))
    calib = [{"tokens": corpus.sample(args.batch)[0]}
             for _ in range(args.calib_batches)]
    t0 = time.perf_counter()
    if args.load_store:
        sess = MemoSession.load(args.load_store, model, params,
                                device=device)
        # the storage spec (codec, index, embed shapes) is the file's; the
        # saved mode supersedes --mode. The serving-policy knobs stay the
        # command line's: threshold (when given) and the online admission
        # settings, applied as a cold build would set them
        print("[serve] note: storage spec (codec/index/embed) comes "
              "from the store file; --codec/--index/--device-index/"
              "--apm-rank are ignored on warm start")
        if sess.spec.runtime.mode != args.mode:
            print(f"[serve] note: saved spec mode "
                  f"{sess.spec.runtime.mode!r} supersedes --mode "
                  f"{args.mode!r}")
            args.mode = sess.spec.runtime.mode
        if args.threshold is not None:
            sess.spec.threshold = args.threshold
        if args.online:
            sess.spec.budget_mb = args.budget_mb
            sess.spec.admit_every = args.admit_every
            sess.spec.recal_every = 2
        print(f"[serve] warm start from {args.load_store} in "
              f"{time.perf_counter()-t0:.2f}s (no calibration)")
    else:
        sess = MemoSession.build(model, params, spec, batches=calib,
                                 seed=1, device=device)
    eng = sess.engine
    store = sess.store
    print(f"[serve] db: {len(store.db)} entries, "
          f"{store.db.nbytes/1e6:.1f} MB ({store.codec.name}: "
          f"{store.entry_nbytes/store.logical_entry_nbytes:.2f}x f16 "
          f"bytes/entry), ready {time.perf_counter()-t0:.1f}s, "
          f"device {device}")
    if args.save_store and not args.online:
        if args.threshold is None:
            _autotune_threshold(eng, corpus, args, "serve")
        sess.save(args.save_store)
        print(f"[serve] session saved -> {args.save_store}")

    if args.prefill:
        if args.threshold is None:
            _autotune_threshold(eng, corpus, args, "prefill")
        return {"prefill": _serve_prefill(eng, model, corpus, args, calib)}

    if args.online:
        if args.threshold is None:
            _autotune_threshold(eng, corpus, args, "online")
        if args.mode == "select":
            print("[online] note: select mode is the host reference path; "
                  "admission still works but the fast path is bucket/kernel")
        res = _serve_online(eng, corpus, args)
        if args.save_store:
            # the post-drift adapted store is the artifact worth keeping
            sess.save(args.save_store)
            print(f"[serve] adapted session saved -> {args.save_store}")
        return {"online": res}

    active = None
    if args.selective:
        if args.threshold is None:
            _autotune_threshold(eng, corpus, args, "serve")
        # profiles t_overhead on the path that will serve; infer() below
        # restricts memoization to the layers whose predicted benefit is
        # positive
        pm = eng.profile(calib[0])
        active = pm.active_layers()
        print(pm.summary())
        print("[serve] selective memo active layers:", active)

    if args.varlen and args.no_fast_path:
        raise SystemExit("--varlen is served by the device fast path "
                         "(or --mode select); drop --no-fast-path")
    return _serve_batches(eng, corpus, args, active)


@torch.no_grad()
def _serve_batches(eng, corpus, args, active):
    """The default leg: each batch memo-free, then memoized."""
    vl_rng = np.random.default_rng(11)

    def sample_batch():
        toks = np.asarray(corpus.sample(args.batch)[0])
        if not args.varlen:
            return {"tokens": toks}
        # a few distinct lengths per batch: pad tokens past each length
        lens = np.asarray(vl_rng.choice(
            [args.seq, args.seq - 4, args.seq // 2], args.batch), np.int32)
        for i, ln in enumerate(lens):
            toks[i, ln:] = 0
        return {"tokens": toks, "lengths": lens}

    lat_memo, lat_plain = [], []
    st = MemoStats()
    n_batches = max(1, args.requests // args.batch)
    batch = None
    out = {}
    for _ in range(n_batches):
        batch = sample_batch()
        t0 = time.perf_counter()
        eng.infer(batch, use_memo=False)
        synchronize(eng.device)
        lat_plain.append(time.perf_counter() - t0)
        if not args.no_memo:
            t0 = time.perf_counter()
            _, st = eng.infer(batch, stats=st, active_layers=active)
            synchronize(eng.device)
            lat_memo.append(time.perf_counter() - t0)
    if args.varlen and not args.no_memo and args.mode == "bucket":
        # padded-row parity: the fast path's mask-aware lookup and gather
        # must match the select reference on the same padded batch
        out_fast, _ = eng.infer(batch, active_layers=active)
        mode0, eng.mc.mode = eng.mc.mode, "select"
        out_sel, _ = eng.infer(batch, active_layers=active)
        eng.mc.mode = mode0
        diff = float((out_fast - out_sel).abs().max())
        print(f"[serve] varlen parity vs select: max|Δlogits| = "
              f"{diff:.2e}")
        out["varlen_max_dlogits"] = diff
    # drop the warm-up batch from the latencies
    p = np.median(lat_plain[1:] or lat_plain) * 1e3
    print(f"[serve] baseline     {p:8.1f} ms/batch")
    if not args.no_memo:
        m = np.median(lat_memo[1:] or lat_memo) * 1e3
        fast = eng._use_fast_path()
        print(f"[serve] memoized     {m:8.1f} ms/batch  "
              f"({(1 - m / p) * 100:+.1f}% latency)"
              + ("  [device fast path]" if fast else "  [host-sync path]"))
        print(f"[serve] memo rate    {st.memo_rate*100:8.1f}%  "
              f"(hits {st.n_hits}/{st.n_layer_attempts})")
        if fast:
            # the fast path keeps no per-phase timers (no per-layer sync)
            print(f"[serve] fused serve  {st.t_total:.2f}s total "
                  f"(event-based stats, one barrier/batch)")
        else:
            print(f"[serve] overhead     embed {st.t_embed:.2f}s "
                  f"search {st.t_search:.2f}s fetch {st.t_fetch:.2f}s")
        out.update(hits=st.n_hits, attempts=st.n_layer_attempts)
    store = eng.store
    if getattr(store, "shard_stats", None) is not None:
        ss = store.shard_stats()
        print(f"[serve] shards       {ss['n_shards']} x "
              f"{ss['positions_per_shard']} positions, occupancy "
              f"{ss['occupancy']} (imbalance {ss['imbalance']:.2f}x), "
              f"evictions {ss['n_shard_evictions']}, "
              f"spills {ss['n_spills']}")
        out["shards"] = ss
    return out


if __name__ == "__main__":
    main()
