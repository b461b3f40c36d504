"""Dry run of every (architecture × input shape) on the production grids
(the reference's ``launch/dryrun.py``), on the ``meta`` device.

``build_step`` makes a step's function and its arguments as meta
tensors; ``count_step`` runs it under ``cost_utils.StepCounter``, which
proves the step runs through every layer at full production size and
counts its FLOPs, bytes, transcendentals, exchanges and peak of live
bytes. A record's ``full`` and ``corrected`` count one device's program
of the grid, as the reference's partitioned HLO does: the arguments
placed by the sharding rules as DTensors on a fake process group of the
grid's shape (``launch/spmd.py``), every op split by DTensor and every
collective it issues counted (``count_step(per_device=True)``). Its
``whole`` keeps the one-controller count of the whole step under the
same keys, and ``fallbacks`` the ops DTensor could not split, which ran
replicated. Nothing is allocated and no card is used: this is analysis
on the host.

Unit correction (the reference's DESIGN.md §7): the reference's HLO
cost analysis counts a scan body once, so its totals come from 1-unit
and 2-unit variants of the same config at full width,
    corrected = unit1 + (reps − 1) · (unit2 − unit1).
The port loops over its layers in Python, so its full-depth count is
already exact; the correction is still computed, and on a config whose
units all cost the same it equals one controller's ``full``, and one
device's up to DTensor's depth-dependent choices (1e-4 of the bytes): a
check of the method.

A pair in ``SCALED`` is the exception: its walks of every layer cannot
finish in an hour on one host core, so ``full`` and ``whole`` are the
same correction (``scale_units``) of their 1-unit and 2-unit walks, the
peak phase by phase, and its record's ``meta["scaled"]`` says so. At
reduced configs the scaled one-controller FLOPs, bytes, transcendentals
and exchanges equal the walk's and the peak lies within a few bytes of
it; one device's program is not quite linear in depth (DTensor's
choices for a stacked leaf change with the layer count), and its scaled
count lies within 1e-3 of the walk's (``tests/test_torch_dryrun.py``);
``scripts/dryrun_scale_check.py`` holds a scaled count against a walked
record at full size.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_1_5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--single-pod-only] [--out DIR]
  python3 scripts/dryrun_batch.py --jobs 8 --hillclimb   # every pair, batched
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch.cost_utils import (COLLECTIVES, StepCounter,
                                           arg_summary, collective_bytes,
                                           cost_summary, device_bytes)
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.launch.spmd import grid_of
from repro_torch.launch.steps import build_step
from repro_torch.sharding.rules import place, redistribute

ASSIGNED = [a for a in ARCH_IDS if a not in ("bert_base", "gpt2_small")]

# (arch, shape, mesh) pairs whose walks of every layer, one device's
# program and the whole step's, cannot finish on one host core in an
# hour: ``main`` and the hillclimb count them with ``scale=True``. One
# controller's walk alone took, on an 8-core host running 8 pairs at
# once: kimi_k2's train step (60 MoE layers of 16 dispatch chunks,
# forward, remat and backward) 2,775 s on (16, 16) and more on
# (2, 16, 16); rwkv6's prefill_32k 1,973 s and 1,785 s and its
# train_4k 1,700 s and 1,564 s (a 32,768- and a 4,096-step Python scan
# a layer); dbrx's train step 1,022 s and 1,862 s.
SCALED = frozenset(
    (arch, shape, grid) for arch, shape in (
        ("kimi_k2_1t_a32b", "train_4k"), ("rwkv6_3b", "prefill_32k"),
        ("rwkv6_3b", "train_4k"), ("dbrx_132b", "train_4k"))
    for grid in ("pod256", "pod512"))


def unit_info(cfg):
    unit = len(cfg.layer_pattern) if cfg.layer_pattern != ("mix",) else 1
    start = cfg.dense_first_n
    reps = (cfg.n_layers - start) // unit
    tail = cfg.n_layers - start - reps * unit
    return unit, start, reps, tail


def small_variant(cfg, n_units: int):
    """Same config at full width with ``n_units`` repeats of its layer
    unit (leading dense layers and hybrid tails preserved)."""
    unit, start, reps, tail = unit_info(cfg)
    cfg2 = cfg.replace(n_layers=start + unit * n_units + tail)
    if cfg.encoder is not None:
        cfg2 = cfg2.replace(encoder=replace(cfg.encoder, n_layers=n_units))
    return cfg2


def count_step(arch, shape_name, mesh, *, cfg=None, rules_overrides=None,
               verbose=False, donate=False, per_device=False):
    """The counterpart of the reference's ``lower_and_compile``: build the
    step and run it on meta tensors under ``StepCounter``. Returns
    (built, metrics) with ``cost_summary``'s keys, ``collectives`` and
    ``fallbacks``, or (None, None) for a skipped pair.

    ``per_device`` counts one device's program of the grid, as the
    reference's partitioned HLO does: the arguments placed by their
    ``in_shardings`` as DTensors on a fake grid of ``mesh``'s shape
    (``launch/spmd.py``), the outputs moved to their ``out_shardings``
    as XLA moves them. Otherwise the whole step on one controller."""
    built = build_step(arch, shape_name, mesh,
                       rules_overrides=rules_overrides, cfg=cfg)
    if built is None:
        return None, None
    metrics = count_built(built, mesh, per_device=per_device, donate=donate)
    if verbose:
        print("  memory: args %.3e B/device, peak %.3e B (%s)"
              % (metrics["arg_bytes"], metrics["peak_bytes"],
                 "one device" if per_device else "one controller"))
        print("  cost: flops=%.3e bytes=%.3e" % (metrics["flops"],
                                                 metrics["bytes"]))
    return built, metrics


def count_built(built, mesh, *, per_device=False, donate=False):
    """``count_step``'s metrics of a built step (``fn``, ``args``,
    ``in_shardings``, ``out_shardings``, ``meta["kind"]``)."""
    if per_device:
        with grid_of(mesh) as grid:
            args = place(built["args"], built["in_shardings"], grid)
            counter = StepCounter(*args, per_device=True)
            counter.run(lambda *a: redistribute(built["fn"](*a),
                                                built["out_shardings"]),
                        *args)
            metrics = cost_summary(counter, dict(built, args=args),
                                   donate=donate)
            counter.out = args = None
    else:
        counter = StepCounter(*built["args"])
        with use_mesh(mesh):
            counter.run(built["fn"], *built["args"])
        metrics = cost_summary(counter, built, donate=donate)
    metrics["collectives"] = collective_bytes(counter)
    metrics["peak_by_phase"] = dict(counter.phase_peaks)
    metrics["fallbacks"] = dict(counter.fallbacks)
    return metrics


def unit_counts(arch, shape_name, mesh, cfg, rules_overrides=None,
                per_device=False):
    """``count_step``'s metrics of the 1-unit and 2-unit variants of
    ``cfg`` (``small_variant``)."""
    return tuple(count_step(arch, shape_name, mesh,
                            cfg=small_variant(cfg, n),
                            rules_overrides=rules_overrides,
                            per_device=per_device)[1]
                 for n in (1, 2))


SCALED_KEYS = ("flops", "bytes", "transcendentals")


def scale_units(m1, m2, reps):
    """The full-depth counts from the 1-unit and 2-unit ones,
    unit1 + (reps − 1)·(unit2 − unit1), for every count ``count_step``
    returns that grows with depth: FLOPs, bytes, transcendentals and
    every exchange. The peak is scaled phase by phase
    (``StepCounter.phase_peaks``) and the largest taken: a phase's peak
    grows linearly with depth, but which phase holds the step's peak can
    change with it: on kimi_k2's train step at full width the secant of
    the whole step's peaks gives 69% of the walked peak, this all of it
    (``scripts/dryrun_scale_check.py``). The temporaries are that peak
    less the step's arguments and outputs, which grow linearly."""
    def lin(a, b):
        return a + (reps - 1) * (b - a)
    out = {k: lin(m1[k], m2[k]) for k in SCALED_KEYS}
    p1, p2 = m1["peak_by_phase"], m2["peak_by_phase"]
    out["peak_bytes"] = max(lin(p1[ph], p2[ph]) for ph in p1 if ph in p2)
    held = lin(m1["peak_bytes"] - m1["temp_bytes"],
               m2["peak_bytes"] - m2["temp_bytes"])
    out["temp_bytes"] = max(0, out["peak_bytes"] - held)
    c1, c2 = m1["collectives"], m2["collectives"]
    out["collectives"] = {k: lin(c1[k], c2[k])
                          for k in COLLECTIVES + ("total",)}
    out["collectives"]["counts"] = {k: lin(c1["counts"][k],
                                           c2["counts"][k])
                                    for k in COLLECTIVES}
    f1, f2 = m1.get("fallbacks", {}), m2.get("fallbacks", {})
    out["fallbacks"] = {k: lin(f1.get(k, 0), f2.get(k, 0))
                        for k in sorted(set(f1) | set(f2))}
    return out


def _counts(arch, shape_name, mesh, cfg, cfg_override, rules_overrides,
            *, scaled, reps, donate, verbose, per_device):
    """(built, metrics, m1, m2): the full-depth step's metrics, walked, or
    for ``scaled`` scaled from the 1-unit and 2-unit walks ``m1`` and
    ``m2`` (None otherwise)."""
    if not scaled:
        built, metrics = count_step(
            arch, shape_name, mesh, cfg=cfg_override,
            rules_overrides=rules_overrides, verbose=verbose,
            donate=donate, per_device=per_device)
        return built, metrics, None, None
    built = build_step(arch, shape_name, mesh,
                       rules_overrides=rules_overrides, cfg=cfg_override)
    if built is None:
        return None, None, None, None
    if built["meta"]["kind"] not in ("train", "prefill"):
        raise ValueError("scale=True counts train and prefill steps only")
    m1, m2 = unit_counts(arch, shape_name, mesh, cfg, rules_overrides,
                         per_device=per_device)
    metrics = scale_units(m1, m2, reps)
    metrics.update(arg_summary(built, donate=donate))
    # the outputs' per-device bytes come from the full-depth step, as
    # the arguments' do (a 1- or 2-unit stack shards otherwise)
    metrics["out_bytes"] = device_bytes(built["out_abs"],
                                        built["out_shardings"])
    built["meta"]["scaled"] = {
        "loop": "layers", "walked_units": [1, 2], "units": reps,
        "walked_layers": [small_variant(cfg, n).n_layers for n in (1, 2)]}
    return built, metrics, m1, m2


def run_one(arch, shape_name, multi_pod, *, correct_scan=True,
            rules_overrides=None, verbose=True, tag="", cfg_override=None,
            donate=False, scale=False, per_device=True):
    """One pair's record. ``full`` and ``corrected`` hold one device's
    program of the grid (``count_step(per_device=True)``) and ``whole``
    the one-controller count of the whole step, under the same keys; with
    ``per_device=False`` ``full`` is that whole count and there is no
    ``whole``. ``fallbacks`` names the ops that ran replicated, as GSPMD
    runs an op it cannot partition. ``scale=True`` (train and prefill
    steps) walks only the 1-unit and 2-unit variants and scales them,
    one device's and the whole step's, to full depth
    (``scale_units``), for a pair whose walk of every layer cannot finish
    (``SCALED``); its ``meta["scaled"]`` says so, and the argument and
    output bytes a device still come from the full-depth step."""
    mesh_name = "pod512" if multi_pod else "pod256"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "devices": 512 if multi_pod else 256, "tag": tag}
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = cfg_override or get_config(arch)
    unit, start, reps, tail = unit_info(cfg)
    scaled = scale and reps > 1
    kw = dict(scaled=scaled, reps=reps, donate=donate, verbose=verbose)
    try:
        built, metrics, m1, m2 = _counts(
            arch, shape_name, mesh, cfg, cfg_override, rules_overrides,
            per_device=per_device, **kw)
        if built is None:
            rec["status"] = "skipped"
            rec["reason"] = ("long_500k needs a sub-quadratic variant; "
                             "this arch has none configured")
            return rec
        rec["meta"] = built["meta"]
        del built
        metrics.pop("peak_by_phase", None)
        rec["fallbacks"] = metrics.pop("fallbacks")
        rec["full"] = metrics
        if per_device:
            whole = _counts(arch, shape_name, mesh, cfg, cfg_override,
                            rules_overrides, per_device=False, **kw)[1]
            whole.pop("peak_by_phase", None)
            whole.pop("fallbacks")
            rec["whole"] = whole
        rec["scan_reps"] = reps
        if (correct_scan or scaled) and reps > 1:
            if m1 is None:
                m1, m2 = unit_counts(arch, shape_name, mesh, cfg,
                                     rules_overrides, per_device=per_device)
            corr = {}
            for k in ("flops", "bytes", "transcendentals"):
                corr[k] = m1[k] + (reps - 1) * (m2[k] - m1[k])
            dcoll = (m2["collectives"]["total"]
                     - m1["collectives"]["total"])
            corr["collective_bytes"] = (m1["collectives"]["total"]
                                        + (reps - 1) * dcoll)
            rec["unit1"] = {k: m1[k] for k in ("flops", "bytes")}
            rec["unit1"]["collective_bytes"] = m1["collectives"]["total"]
            rec["unit2"] = {k: m2[k] for k in ("flops", "bytes")}
            rec["unit2"]["collective_bytes"] = m2["collectives"]["total"]
            rec["corrected"] = corr
        else:
            rec["corrected"] = {
                "flops": metrics["flops"], "bytes": metrics["bytes"],
                "collective_bytes": metrics["collectives"]["total"]}
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — report failures as data
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["elapsed_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--no-correct", action="store_true")
    ap.add_argument("--donate", action="store_true",
                    help="count the donated input buffers (alias_bytes), "
                         "the launchers' production configuration")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True]
    if args.multi_pod or args.multi_pod_only:
        meshes = [True]
    elif args.single_pod_only:
        meshes = [False]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                grid = "pod512" if mp else "pod256"
                key = f"{arch}_{shape}_{grid}"
                path = os.path.join(args.out, key + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip existing] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                # the multi-pod pass proves the step runs; corrections are
                # for the single-pod table
                rec = run_one(arch, shape, mp, donate=args.donate,
                              correct_scan=(not args.no_correct) and not mp,
                              scale=(arch, shape, grid) in SCALED)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"   -> {rec['status']} ({rec.get('elapsed_s', 0)}s)"
                      + (f"  {rec.get('error', '')}"
                         if rec["status"] == "error" else ""), flush=True)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n{n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed / {len(results)}")
    return results


if __name__ == "__main__":
    main()
