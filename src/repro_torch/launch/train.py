"""Training launcher (the reference's ``launch/train.py``).

    python -m repro_torch.launch.train --arch gpt2_small --steps 30 \\
        --batch 8 --seq 1024 --ckpt checkpoints/gpt2.npz
    python -m repro_torch.launch.train --arch gpt2_small --reduced \\
        --steps 200 --device cpu

Trains the arch (its reduced config with ``--reduced``) from random
weights made from ``--seed`` on ``TemplateCorpus`` LM batches, with the
config's optimizer and ``Trainer``'s cosine schedule. It runs on the
CUDA card unless ``--device cpu`` is given, and raises when there is no
card. ``--ckpt`` writes the params in the checkpoint format both
packages load; ``repro_torch.launch.serve --ckpt`` serves it (at the
full config when the checkpoint was trained at it).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import TemplateCorpus, lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.checkpoint import save_checkpoint


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the launcher; returns (params, history)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.encoder is not None:
        raise SystemExit(
            f"{args.arch!r} is an encoder-decoder model: its batches need "
            f"frames, which this launcher does not make")
    model = build_model(cfg, device=device)
    params = model.init(args.seed)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=args.seq,
                            seed=args.seed)
    n = max(1, args.grad_accum)
    stream = lm_batches(cfg.vocab, args.seq, args.batch, args.steps * n,
                        corpus=corpus)
    if n > 1:
        # each step's batch stacks n micro-batches on a leading axis
        def accum_batches(batches):
            while True:
                group = [next(batches, None) for _ in range(n)]
                if group[-1] is None:
                    return
                yield {"tokens": np.stack([g["tokens"] for g in group])}
        stream = accum_batches(stream)
    trainer = Trainer(model, TrainConfig(
        steps=args.steps, lr=args.lr, grad_accum=args.grad_accum,
        optimizer=cfg.optimizer, log_every=10))
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active), device "
          f"{model.device}")
    params, _, hist = trainer.fit(params, stream)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps,
                        meta={"arch": cfg.name})
        print(f"[train] checkpoint -> {args.ckpt}")
    print(f"[train] done: loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}")
    return params, hist


if __name__ == "__main__":
    main()
