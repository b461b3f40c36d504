#!/usr/bin/env python3
"""Decode parity after memoized prefill on qwen2_1_5b, dbrx_132b or
recurrentgemma_2b, and whisper_medium's logits after its memoized
encoder, over seeds and against deliberately faulted caches or APMs, on
one card.

    python3 scripts/zoo_decode_parity.py [--arch dbrx_132b] [--seeds 0 1 2]

For each seed it builds chip_smoke's phase-8b session (qwen2_1_5b at full
width and depth, random weights and TemplateCorpus from the seed, int8
APM and K/V over ZOO_CALIB calibration batches) or, with ``--arch
dbrx_132b``, phase 9b's (dbrx at full width cut to DBRX_LAYERS layers,
DBRX_CALIB calibration batches) or, with ``--arch recurrentgemma_2b``,
phase 10b's (full width and depth, RG_CALIB calibration batches; the
RG-LRU layers' states ride in the caches untouched), replays the first
calibration batch through memoized ``prefill`` at threshold -1e9 (every
row hits its own entry on every layer) and through ``prefill_exact``,
and runs chip_smoke's ``zoo_decode``: PREFILL_DECODE_STEPS teacher-forced
greedy steps from both cache sets, max|dlogits| (also as a share of
max|logit|) and argmax agreement; on dbrx the memoized side runs on the
exact side's expert picks, so every row is compared at every step.
That is the sound reading. Two controls decode from the same memoized
caches with a fault put in:

* ``kv_step``: every layer's K/V off by one more int8 step (the codec's
  row step, amax / 127 over a row's KV heads), in a random sign per
  element, as a codec or kernel that loses one bit would leave them;
* ``kv_heads``: the last layer's KV heads in reverse order (qwen2's two
  swapped), as a GQA fault that maps query heads to the wrong KV head
  would leave them; with one KV head (recurrentgemma's MQA) ``kv_slot``
  instead: the last attention layer's K/V one slot off (rolled by one
  position), as an off-by-one in the cache's slots would leave them.

With ``--arch whisper_medium`` it builds phase 10c's engine leg
(``chip_smoke.whisper_session``: full width, encoder and decoder cut to
WHISPER_LAYERS layers, weights from the seed, int8 APMs on the host
tier) and runs ``chip_smoke.whisper_replay``: the first calibration
batch through the memoized encoder, every row on its own entry, its
logits against the memo-free path's as max|dlogits| / max|logit| (the
sound reading), and the same with the decoded APM's heads rolled by one
(``apm_heads``) or each row's entry of the layer before (``apm_layer``).

A bound on the sound reading belongs between the largest sound reading
and the smallest control. Prints one line per reading and a JSON object
last. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _faulted(torch, dev, eng, caches, fault, seed):
    """A copy of ``caches`` with ``fault`` put into its K/V leaves."""
    by = {li: dict(c) for li, c in eng._split_caches(caches).items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    last = max(li for li, c in by.items() if "k" in c)
    for li, c in by.items():
        if "k" not in c or (fault in ("kv_heads", "kv_slot") and li != last):
            continue          # an RG-LRU state, or not the faulted layer
        for name in ("k", "v"):
            x = c[name]
            if fault in ("kv_heads", "kv_slot"):
                c[name] = x.flip(2) if fault == "kv_heads" else x.roll(1, 1)
                continue
            step = x.flatten(2).abs().amax(-1) / 127.0   # (B, Sc)
            sign = torch.randint(0, 2, x.shape, generator=gen,
                                 device=x.device) * 2 - 1
            c[name] = x + sign * step[:, :, None, None]
    return eng._merge_caches(by)


def _whisper(torch, dev, cs, cfg, seeds) -> int:
    controls = ("apm_heads", "apm_layer")
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        _, sess, calib, _, thr, _ = cs.whisper_session(torch, dev, cfg, seed)
        free, _ = sess.infer(calib[0], use_memo=False)
        rel = cs.whisper_replay(torch, sess, calib[0], thr, free)
        for label in ("sound",) + controls:
            print(f"whisper_medium seed {seed} {label}: max|dlogits| = "
                  f"{rel[label]:.4e} of max|logit| "
                  f"{free.abs().max().item():.3f}")
        out.append(dict(seed=seed, threshold=thr, **rel))
        del sess, calib, free
        torch.cuda.empty_cache()
        print(f"seed {seed} took {time.perf_counter() - t0:.1f}s")
    summary = dict(sound_max_rel=max(r["sound"] for r in out),
                   control_min_rel=min(r[c] for r in out for c in controls))
    print(f"whisper_medium: largest sound reading "
          f"{summary['sound_max_rel']:.4e} of max|logit|, smallest control "
          f"{summary['control_min_rel']:.4e}")
    print(json.dumps({"arch": "whisper_medium", "runs": out, **summary}))
    return 0


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=("qwen2_1_5b", "dbrx_132b",
                                       "recurrentgemma_2b", "whisper_medium"),
                    default="qwen2_1_5b")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_decode_parity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line())
    from repro_torch.configs import get_config
    if args.arch == "whisper_medium":
        return _whisper(torch, dev, cs, get_config(args.arch), args.seeds)
    kw = {}
    if args.arch == "dbrx_132b":
        kw = dict(cfg=get_config(args.arch).replace(n_layers=cs.DBRX_LAYERS),
                  n_calib=cs.DBRX_CALIB)
    elif args.arch == "recurrentgemma_2b":
        kw = dict(cfg=get_config(args.arch), n_calib=cs.RG_CALIB)
    controls = ("kv_step", "kv_heads" if get_config(args.arch).n_kv_heads > 1
                else "kv_slot")
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        model, params, sess, calib, _, _ = cs.zoo_session(
            torch, dev, seed, n_fresh=0, **kw)
        eng = sess.engine
        lm, cm, st = eng.prefill(calib[0], threshold=-1e9)
        le, ce = eng.prefill_exact(calib[0])
        cs.require(st.n_hits == st.n_layer_attempts, f"seed {seed}: misses")
        row = dict(seed=seed)
        for label in ("sound",) + controls:
            caches = cm if label == "sound" else _faulted(
                torch, dev, eng, cm, label, seed)
            dmax, agree, n_tok, scale, moved = cs.zoo_decode(
                torch, model, params, lm, caches, le, ce)
            row[label] = dict(max_dlogits=dmax, rel=dmax / scale,
                              agreement=agree / n_tok, logit_scale=scale,
                              route_moved=moved)
            print(f"{args.arch} seed {seed} {label}: max|dlogits| "
                  f"{dmax:.4e} = {dmax / scale:.4e} of max|logit| "
                  f"{scale:.3f}, greedy agreement {agree}/{n_tok}, "
                  f"(token, layer) expert picks of the memoized side's own "
                  f"that differed {moved}")
        out.append(row)
        del model, params, sess, eng, cm, ce, caches
        torch.cuda.empty_cache()
        print(f"seed {seed} took {time.perf_counter() - t0:.1f}s")
    summary = {}
    for key in ("max_dlogits", "rel"):
        summary[f"sound_max_{key}"] = max(r["sound"][key] for r in out)
        summary[f"control_min_{key}"] = min(
            r[c][key] for r in out for c in controls)
    print(f"{args.arch}: largest sound reading "
          f"{summary['sound_max_max_dlogits']:.4e} "
          f"({summary['sound_max_rel']:.4e} of max|logit|), smallest control "
          f"{summary['control_min_max_dlogits']:.4e} "
          f"({summary['control_min_rel']:.4e})")
    print(json.dumps({"arch": args.arch, "runs": out, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
