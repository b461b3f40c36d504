"""Serving example on the PyTorch port — the full memo lifecycle
through ``repro_torch.memo`` (the counterpart of ``serve_memo.py``).

Walks what the facade exposes (DESIGN.md §2.5–2.8): build → lookup →
online admission under a byte budget → CLOCK eviction → generation-
counted delta sync → atomic snapshot publish — then serves an open-loop
variable-length request stream through ``session.serve()`` (the
MemoServer runtime with off-thread maintenance). Runs on the CUDA card
(bucket mode's device fast path launches ``nn_search``); ``--device
cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_serve_memo.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.device import resolve_device
from repro_torch.memo import (
    AdmissionPolicy, EmbedSpec, MemoSession, MemoSpec, RuntimeSpec)
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train.trainer import value_and_grad

SEQ = 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced("bert_base").replace(n_classes=4, n_layers=2)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, seed=2,
                            n_templates=6, slot_fraction=0.2)

    # a briefly-trained classifier (the paper's BERT/SST-2 analogue)
    opt = adamw_init(params)
    for b in corpus.batches(30, 32):
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        _, g = value_and_grad(model.classify_loss, params, b)
        params, opt = adamw_update(params, g, opt, lr=3e-4)

    # --- build: calibration corpus becomes the store's first epoch -------
    spec = MemoSpec(
        runtime=RuntimeSpec(threshold=0.8, mode="bucket", device_slack=8.0),
        embed=EmbedSpec(steps=80),
        admission=AdmissionPolicy(enabled=True, budget_mb=64.0,
                                  recal_every=2))
    calib = [{"tokens": corpus.sample(16)[0]} for _ in range(4)]
    session = MemoSession.build(model, params, spec, batches=calib, seed=1,
                                device=dev)
    # per-model threshold autotune (paper Table 2 / §5.4) from a fresh sample
    session.autotune([{"tokens": corpus.sample(16)[0]}], level="aggressive")
    store = session.store
    print(f"[store] built: {len(store.db)} entries, "
          f"{store.live_count * store.entry_nbytes / 1e6:.2f} MB "
          f"({store.codec.name} codec), threshold "
          f"{spec.runtime.threshold:.3f} (autotuned)")
    built = len(store.db)

    # --- lookup: the host-tier search API --------------------------------
    # (the engine embeds internally; query with stored calibration
    # embeddings to show the raw store API)
    q = store.embeddings_at(np.arange(4))
    dist, slots = store.lookup(q, k=1)
    print(f"[store] lookup: top-1 slots {slots[:, 0].tolist()} at L2 "
          f"{np.round(dist[:, 0], 4).tolist()} (self-queries → 0)")

    # --- online admission: drifted traffic, captured misses, delta sync --
    drifted = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, seed=117,
                             n_templates=6, slot_fraction=0.2)
    rates = []
    for i in range(6):
        _, st = session.infer({"tokens": drifted.sample(16)[0]})
        rates.append(st.memo_rate)
    s = store.stats
    print(f"[store] drift hit-rate {' '.join(f'{r:.2f}' for r in rates)} — "
          f"{s.n_admitted} admitted, {s.n_delta_syncs} delta syncs "
          f"({s.bytes_delta / 1e6:.2f} MB shipped vs "
          f"{s.n_delta_syncs * len(store.db) * store.entry_nbytes / 1e6:.1f}"
          f" MB full-resync strawman)")

    # --- eviction: reuse-aware CLOCK, tombstoned index rows --------------
    before = store.live_count
    store.evict(8)
    store.sync()                       # ships the tombstones, publishes
    evicted = before - store.live_count
    print(f"[store] evicted {evicted} cold entries "
          f"(live {store.live_count}); snapshot generation "
          f"{store.snapshot.generation}")

    # --- the serving runtime: open-loop variable-length requests ---------
    rng = np.random.default_rng(7)
    wl = []
    t = 0.0
    for i in range(32):
        t += float(rng.exponential(0.01))
        ln = int(rng.choice([SEQ // 2, SEQ]))
        wl.append((t, np.asarray(drifted.sample(1)[0][0, :ln])))
    t0 = time.perf_counter()
    with session.serve(buckets=(SEQ // 2, SEQ), max_batch=8,
                       async_maintenance=True) as server:
        server.warmup()
        comps = server.run(wl)
    wall = time.perf_counter() - t0
    lat = np.asarray([c.latency for c in comps]) * 1e3
    print(f"[serve] {len(comps)} requests in {wall:.2f}s "
          f"({len(comps) / wall:.0f} req/s) | p50 "
          f"{np.percentile(lat, 50):.1f} ms p99 "
          f"{np.percentile(lat, 99):.1f} ms | hit rate "
          f"{server.stats.memo_rate * 100:.0f}% | "
          f"{server.stats.n_admitted} admitted off-thread")
    return dict(built=built, self_dist=float(np.abs(dist[:, 0]).max()),
                self_slots=slots[:, 0].tolist(), admitted=s.n_admitted,
                delta_syncs=s.n_delta_syncs, evicted=evicted,
                served=len(comps), requests=len(wl))


if __name__ == "__main__":
    main()
