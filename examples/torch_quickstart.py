"""Quickstart on the PyTorch port: AttMemo in ~60 lines, through the
``repro_torch.memo`` facade (the counterpart of ``quickstart.py``).

Train a small encoder on the template corpus, build a memoization
session (attention + index databases behind one object), and compare
plain vs memoized inference. Runs on the CUDA card (bucket mode's
device fast path launches ``nn_search``); ``--device cpu`` runs it on
the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] \\
        [--small]

--small shrinks training and the embedder's to a CI-sized run.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.device import resolve_device, synchronize
from repro_torch.memo import EmbedSpec, MemoSession, MemoSpec, RuntimeSpec
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train.trainer import value_and_grad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a small BERT-family classifier (the paper's primary evaluation model)
    cfg = get_reduced("bert_base").replace(n_classes=4, n_layers=4)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=64, n_templates=8,
                            slot_fraction=0.25)

    # 2. brief training
    opt = adamw_init(params)
    print("training ...")
    for batch in corpus.batches(10 if args.small else 40, 32):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, g = value_and_grad(model.classify_loss, params, batch)
        params, opt = adamw_update(params, g, opt, lr=3e-4)
    print(f"  final loss {float(loss):.4f}")

    # 3. build the memoization session from a calibration stream
    spec = MemoSpec(runtime=RuntimeSpec(threshold=0.8, mode="bucket"),
                    embed=EmbedSpec(steps=60 if args.small else 300))
    calib = [{"tokens": corpus.sample(32)[0]} for _ in range(5)]
    session = MemoSession.build(model, params, spec, batches=calib, seed=1,
                                verbose=True, device=dev)
    store = session.store
    print(f"attention DB: {len(store.db)} APMs, {store.db.nbytes/1e6:.1f} MB")

    # per-model threshold calibration (paper Table 2 / §5.4 autotuner)
    levels = session.autotune([{"tokens": corpus.sample(16)[0]}],
                              level="aggressive")
    print(f"calibrated thresholds: {levels}")

    # 4. plain vs memoized inference
    toks, labels = corpus.sample(64)
    batchd = {"tokens": toks}

    session.infer(batchd, use_memo=False)             # warm both paths
    session.infer(batchd)

    t0 = time.perf_counter()
    logits, _ = session.infer(batchd, use_memo=False)
    synchronize(dev)
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits_m, st = session.infer(batchd)
    synchronize(dev)
    t_memo = time.perf_counter() - t0

    acc = (np.argmax(logits.cpu().numpy(), -1) == labels).mean()
    acc_m = (np.argmax(logits_m.cpu().numpy(), -1) == labels).mean()
    print(f"plain    : {t_plain*1e3:7.1f} ms  acc {acc:.3f}")
    print(f"memoized : {t_memo*1e3:7.1f} ms  acc {acc_m:.3f}  "
          f"memo-rate {st.memo_rate*100:.0f}%")
    return dict(loss=float(loss), entries=len(store.db), acc=float(acc),
                acc_memo=float(acc_m), memo_rate=float(st.memo_rate),
                finite=bool(torch.isfinite(logits_m).all()))


if __name__ == "__main__":
    main()
