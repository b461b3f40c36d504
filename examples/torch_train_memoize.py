"""End-to-end driver on the PyTorch port (the counterpart of
``train_memoize.py``): train a ~100M-param GPT-2-class LM for a few
hundred steps with the full substrate (data pipeline, AdamW, cosine
schedule, checkpointing), then build an AttMemo database from the
trained model and report memoized scoring. Runs on the CUDA card;
``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_train_memoize.py [--steps 300] \\
        [--small] [--device cpu]

--small shrinks to a CI-sized run (default is the real ~100M config).
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import TemplateCorpus, lm_batches
from repro_torch.device import resolve_device
from repro_torch.memo import EmbedSpec, MemoSession, MemoSpec, RuntimeSpec
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.checkpoint import save_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt", default="checkpoints/gpt2_memo_torch.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.small:
        cfg = get_reduced("gpt2_small").replace(n_layers=4)
        seq, batch = args.seq or 64, args.batch or 8
    else:
        cfg = get_config("gpt2_small")          # ~110M params (paper Table 1)
        seq, batch = args.seq or 256, args.batch or 8

    print(f"[e2e] {cfg.name}: {cfg.param_count()/1e6:.0f}M params, "
          f"{args.steps} steps @ batch {batch} x seq {seq}, device {dev}")
    model = build_model(cfg, device=dev)
    params = model.init(0)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=seq, n_templates=16,
                            slot_fraction=0.3, seed=0)

    trainer = Trainer(model, TrainConfig(steps=args.steps, lr=3e-4,
                                         warmup=max(10, args.steps // 10),
                                         log_every=max(1, args.steps // 10)))
    params, _, hist = trainer.fit(
        params, lm_batches(cfg.vocab, seq, batch, args.steps, corpus=corpus))
    print(f"[e2e] loss {hist[0][1]:.3f} -> {hist[-1][1]:.3f}")
    save_checkpoint(args.ckpt, params, step=args.steps,
                    meta={"arch": cfg.name})

    # --- memoize the trained decoder's self-attention -----------------------
    spec = MemoSpec(runtime=RuntimeSpec(threshold=0.9, mode="select",
                                        max_layers=4),
                    embed=EmbedSpec(steps=150))
    calib = [{"tokens": corpus.sample(batch)[0]} for _ in range(4)]
    sess = MemoSession.build(model, params, spec, batches=calib, seed=1,
                             verbose=True, device=dev)
    db = sess.store.db
    print(f"[e2e] DB {len(db)} APMs / {db.nbytes/1e6:.1f} MB")
    sess.autotune([{"tokens": corpus.sample(batch)[0]}], level="moderate")

    toks = corpus.sample(batch)[0]
    logits_p, _ = sess.infer({"tokens": toks}, use_memo=False)
    logits_m, st = sess.infer({"tokens": toks})
    # memoized scoring must stay close in next-token ranking
    agree = (np.argmax(logits_p.cpu().numpy(), -1)
             == np.argmax(logits_m.cpu().numpy(), -1)).mean()
    print(f"[e2e] memo-rate {st.memo_rate*100:.0f}%  "
          f"next-token agreement {agree*100:.1f}%")
    return dict(first_loss=hist[0][1], last_loss=hist[-1][1],
                entries=len(db), memo_rate=float(st.memo_rate),
                agreement=float(agree), ckpt=args.ckpt)


if __name__ == "__main__":
    main()
