"""Warm-start serving on the PyTorch port — the paper's offline-built
database, shipped (the counterpart of ``warm_start.py``).

AttMemo assumes the memo database is built offline and served from big
memory (paper §5.1); ``MemoSession.save``/``load`` makes that real: one
process calibrates and persists the populated store (codec arenas, index
state, sim_cal, entry lengths, trained embedder, full spec), another
loads it and serves immediately — no calibration pass, no embedder
training, identical lookups. Runs on the CUDA card (bucket mode's
device fast path launches ``nn_search``); ``--device cpu`` runs it on
the CPU.

    PYTHONPATH=src python examples/torch_warm_start.py [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.device import resolve_device
from repro_torch.memo import EmbedSpec, MemoSession, MemoSpec, RuntimeSpec
from repro_torch.models import build_model

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
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, seed=3,
                            n_templates=6, slot_fraction=0.2)

    # --- the "offline" leg: calibrate, autotune, persist -----------------
    spec = MemoSpec(runtime=RuntimeSpec(mode="bucket"),
                    embed=EmbedSpec(steps=60))
    calib = [{"tokens": corpus.sample(16)[0]} for _ in range(4)]
    t0 = time.perf_counter()
    offline = MemoSession.build(model, params, spec, batches=calib, seed=1,
                                device=dev)
    offline.autotune([{"tokens": corpus.sample(16)[0]}], level="aggressive")
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "memo_store.npz")
        offline.save(path)
        print(f"[offline] built in {build_s:.1f}s, saved "
              f"{os.path.getsize(path)/1e6:.2f} MB "
              f"({offline.store.live_count} entries, "
              f"{offline.store.codec.name} codec) -> {path}")

        # --- the "serving" leg: load and serve, no calibration -----------
        t0 = time.perf_counter()
        warm = MemoSession.load(path, model, params, device=dev)
        load_s = time.perf_counter() - t0
    print(f"[warm] loaded in {load_s:.2f}s "
          f"({build_s / max(load_s, 1e-9):.0f}x faster than rebuilding)")

    toks = corpus.sample(16)[0]
    out_off, st_off = offline.infer({"tokens": toks})
    out_warm, st_warm = warm.infer({"tokens": toks})
    same = bool(torch.equal(out_off, out_warm))
    print(f"[warm] hit rate {st_warm.memo_rate:.2f} "
          f"(offline session: {st_off.memo_rate:.2f}); "
          f"logits identical: {same}")
    if not (same and st_warm.memo_rate == st_off.memo_rate):
        raise RuntimeError("the loaded session serves other lookups than "
                           "the one it was saved from")

    # serve an open-loop trace straight off the loaded store
    rng = np.random.default_rng(5)
    wl, t = [], 0.0
    for _ in range(24):
        t += float(rng.exponential(0.01))
        wl.append((t, np.asarray(corpus.sample(1)[0][0])))
    with warm.serve(buckets=(SEQ,), max_batch=8) as server:
        server.warmup()
        comps = server.run(wl)
    lat = np.asarray([c.latency for c in comps]) * 1e3
    print(f"[warm] served {len(comps)} requests | p50 "
          f"{np.percentile(lat, 50):.1f} ms | hit rate "
          f"{server.stats.memo_rate * 100:.0f}%")
    return dict(identical=same, memo_rate=float(st_warm.memo_rate),
                memo_rate_offline=float(st_off.memo_rate),
                served=len(comps), requests=len(wl))


if __name__ == "__main__":
    main()
