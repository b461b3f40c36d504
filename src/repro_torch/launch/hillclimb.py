"""Performance hillclimbing on the dry run (the reference's
``launch/hillclimb.py``): the three selected pairs, each iteration a
tagged record with ``launch/dryrun.py::run_one``'s keys, counted on the
``meta`` device, in ``experiments/hillclimb_torch``.

1. minicpm3-4b × train_4k
   - it1 vocab padding to a 256 multiple (shardable lm_head/embedding)
   - it2 MLA latent-dim sharding (q_lora/kv_lora → model)
   - it3 + FSDP (embed over data)
2. rwkv6-3b × train_4k
   - it1 replicate time-mix square projections
   - it2 + FSDP embeddings over data
   - it3 time-mix output dim over data instead
   - it4 it1 + the scan's batch/state over both axes
3. deepseek-7b × prefill (paper-representative, attention-heavy)
   - it0 baseline, it1 50% and it2 94% of the batch memoized: the
     AttMemo technique at grid scale — hit rows run APM·V only against
     a DB sharded over entries, miss rows full attention

Every iteration is its own ``run_one``: one device's program of the
grid under the iteration's rules overrides and ``act_shard_batch``
(``full``), and the one-controller count beside it (``whole``). The
port counts every layer, so ``corrected`` is the full count (no unit
passes).

Run:  python -m repro_torch.launch.hillclimb [--pair 1|2|3] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config, rwkv6_3b
from repro_torch.launch.dryrun import SCALED, count_built, run_one
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import PARAM_DTYPE, abstract_params
from repro_torch.models import attention as attn_mod
from repro_torch.models import backbone as bb
from repro_torch.models.layers import mlp_apply, norm_apply
from repro_torch.models.model import Model
from repro_torch.sharding.rules import (NamedSharding, P,
                                        logical_to_shardings, make_rules)

OUT = "experiments/hillclimb_torch"


def _round_up(x, m):
    return (x + m - 1) // m * m


def _save(rec, name):
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    c = rec.get("corrected", {})
    print(f"  {name}: status={rec['status']} "
          f"flops={c.get('flops', 0):.3e} bytes={c.get('bytes', 0):.3e} "
          f"coll={c.get('collective_bytes', 0):.3e} "
          f"args={rec.get('full', {}).get('arg_bytes', 0)/1e9:.2f}GB/device "
          f"peak={rec.get('full', {}).get('peak_bytes', 0)/1e9:.2f}GB")
    return rec


def _climb(arch, shape, iterations):
    """Each iteration ``(name, tag, cfg, rules_overrides)`` a tagged
    record of ``run_one`` (pod256, no unit passes; a ``SCALED`` pair
    scaled, as the dry run counts it)."""
    scale = (arch, shape, "pod256") in SCALED
    for name, tag, cfg, overrides in iterations:
        _save(run_one(arch, shape, False, correct_scan=False,
                      rules_overrides=overrides, verbose=False, tag=tag,
                      cfg_override=cfg, scale=scale), name)


# ---------------------------------------------------------------- pair 1

def pair1():
    print("[pair1] minicpm3-4b x train_4k")
    cfg = get_config("minicpm3_4b")
    # it1: pad vocab so lm_head/embedding shard over model
    cfg_pad = cfg.replace(vocab=_round_up(cfg.vocab, 256))
    latent = {"q_lora": "model", "kv_lora": "model"}
    _climb("minicpm3_4b", "train_4k", [
        ("minicpm3_train_it1_pad_vocab", "it1_pad_vocab", cfg_pad, None),
        # it2: + shard the MLA latent dims over model (heads 40 can't
        # shard over 16; the latent contraction dims can: 768/16, 256/16)
        ("minicpm3_train_it2_latent_shard", "it2_latent_shard", cfg_pad,
         latent),
        # it3: + FSDP (embed over data)
        ("minicpm3_train_it3_fsdp", "it3_fsdp", cfg_pad,
         dict(latent, embed="data"))])


# ---------------------------------------------------------------- pair 2

def pair2():
    print("[pair2] rwkv6-3b x train_4k")
    cfg = get_config("rwkv6_3b")
    _climb("rwkv6_3b", "train_4k", [
        # it1: replicate time-mix square projections (their model-axis
        # shards, 2560/16 = 160, split the 64-wide wkv heads)
        ("rwkv6_train_it1_replicate_timemix", "it1_replicate_timemix", cfg,
         {"heads_embed": None}),
        # it2: + FSDP embeddings (vocab 65536 divides 16 cleanly)
        ("rwkv6_train_it2_fsdp", "it2_fsdp", cfg,
         {"heads_embed": None, "embed": "data"}),
        # it3: shard the time-mix output dim over data instead
        ("rwkv6_train_it3_timemix_data", "it3_timemix_data", cfg,
         {"heads_embed": "data", "embed": "data"}),
        # it4: it1 + the scan's batch/state over both axes
        ("rwkv6_train_it4_state_batch_shard", "it4_state_batch_shard",
         rwkv6_3b.optimized(),
         {"heads_embed": None})])


# ---------------------------------------------------------------- pair 3

def _prefill_memo_step(mesh, seq, batch, hit_frac, n_db=64):
    """AttMemo at grid scale: the batch is pre-bucketed (engine-level
    bucketing, DESIGN.md §2) into ``B_hit`` sequences whose APMs come from
    the DB sharded over entries (APM·V only — no QKᵀ, no softmax) and
    ``B_miss`` running full attention. Returns (fn, args, in_shardings,
    meta), ``args`` on the mesh's device."""
    cfg = get_config("deepseek_7b")
    dev = mesh.lead
    model = Model(cfg, mesh=mesh)
    rules = make_rules(cfg, mesh)
    params_abs = abstract_params(model, dtype=PARAM_DTYPE)
    params_sh = logical_to_shardings(model.specs(), rules, mesh, params_abs)
    B_hit = _round_up(int(batch * hit_frac), 16) if hit_frac else 0
    B_hit = min(B_hit, batch - 16) if hit_frac < 1.0 else batch
    B_miss = batch - B_hit

    def memo_forward(params, toks_hit, apm_idx, db, toks_miss):
        outs = []
        if toks_hit.shape[0]:
            h = bb.embed_tokens(params, toks_hit, cfg)
            for li, kind, lp in bb.iter_layers(params, cfg):
                x = norm_apply(lp["norm1"], h, cfg.norm)
                apm = db.index_select(0, apm_idx[:, li])
                h = h + attn_mod.gqa_apply_memo(lp["mix"], x, cfg, apm)
                x = norm_apply(lp["norm2"], h, cfg.norm)
                h = h + mlp_apply(lp["chan"], x, cfg.act, cfg.glu)
            outs.append(bb.logits_from_hidden(params, h[:, -1:], cfg)[:, 0])
        if toks_miss.shape[0]:
            logits, _, _ = model.forward(params, {"tokens": toks_miss})
            outs.append(logits[:, -1])
        return torch.cat(outs, 0)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    args = (params_abs,
            empty((B_hit, seq), torch.int32),
            empty((B_hit, cfg.n_layers), torch.int32),
            empty((n_db, cfg.n_heads, seq, seq), PARAM_DTYPE),
            empty((B_miss, seq), torch.int32))

    def tok_sh(b):
        return NamedSharding(mesh, P("data", None) if b % 16 == 0 and b
                             else P())
    in_sh = (params_sh, tok_sh(B_hit),
             NamedSharding(mesh, P()),
             NamedSharding(mesh, P("data")),       # DB sharded over entries
             tok_sh(B_miss))
    return memo_forward, args, in_sh, {"B_hit": B_hit, "B_miss": B_miss,
                                       "n_db": n_db, "seq": seq}


def pair3():
    print("[pair3] deepseek-7b x prefill (paper-representative)")
    mesh = make_production_mesh()
    seq, batch = 2048, 256          # paper-scale sequence; APM DB feasible
    for tag, hit in (("it0_baseline", 0.0), ("it1_hit50", 0.5),
                     ("it2_hit94", 0.94)):
        t0 = time.time()
        fn, args, in_sh, meta = _prefill_memo_step(mesh, seq, batch, hit)
        rec = {"arch": "deepseek_7b", "shape": f"prefill_{seq}",
               "mesh": "pod256", "devices": 256, "tag": tag, "meta": meta,
               "status": "ok"}
        # the reference leaves the logits' placement to XLA; counted
        # replicated here
        built = dict(fn=fn, args=args, in_shardings=in_sh,
                     out_shardings=NamedSharding(mesh, P()),
                     meta={"kind": "prefill"})
        try:
            m, whole = (count_built(built, mesh, per_device=pd)
                        for pd in (True, False))
            for x in (m, whole):
                x.pop("peak_by_phase")
            rec["fallbacks"] = m.pop("fallbacks")
            whole.pop("fallbacks")
            rec["full"], rec["whole"] = m, whole
            rec["corrected"] = {"flops": m["flops"], "bytes": m["bytes"],
                                "collective_bytes": m["collectives"]["total"]}
        except Exception as e:  # noqa: BLE001 — report failures as data
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["elapsed_s"] = round(time.time() - t0, 1)
        _save(rec, f"deepseek_prefill2k_{tag}")


def main(argv=None):
    global OUT
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    OUT = args.out
    if args.pair in (0, 1):
        pair1()
    if args.pair in (0, 2):
        pair2()
    if args.pair in (0, 3):
        pair3()


if __name__ == "__main__":
    main()
