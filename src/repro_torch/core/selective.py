"""Selective memoization — per-layer performance model (paper §5.4), the
counterpart of the reference's ``core/selective.py``.

Eq. 3:  PBⁱ = Tⁱ_attn · αⁱ − Tⁱ_overhead.
Memoization is attempted at layer i only when PBⁱ > 0. The offline profiler
(``MemoEngine.profile``) measures Tⁱ_attn (the attention compute being
replaced), Tⁱ_overhead (embedding + index search + APM fetch) and αⁱ (the
calibration memo rate). At serve time the times scale ~linearly with the
token count, so a single ``scale`` knob adapts the decision to the request
batch (paper: "approximate linear scaling").
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from repro_torch.device import synchronize


@dataclass
class LayerProfile:
    t_attn: float = 0.0          # seconds per calibration batch
    t_overhead: float = 0.0
    alpha: float = 0.0           # memo success rate at this layer


@dataclass
class PerfModel:
    profiles: Dict[int, LayerProfile] = field(default_factory=dict)

    def benefit(self, layer: int, scale: float = 1.0) -> float:
        p = self.profiles.get(layer)
        if p is None:
            return -1.0
        return (p.t_attn * p.alpha - p.t_overhead) * scale

    def active_layers(self, scale: float = 1.0) -> List[int]:
        return [i for i in sorted(self.profiles)
                if self.benefit(i, scale) > 0.0]

    def summary(self) -> str:
        rows = ["layer  t_attn(ms)  t_over(ms)  alpha   PB(ms)  memoize?"]
        for i in sorted(self.profiles):
            p = self.profiles[i]
            pb = self.benefit(i) * 1e3
            rows.append(f"{i:5d}  {p.t_attn*1e3:9.3f}  {p.t_overhead*1e3:9.3f}"
                        f"  {p.alpha:5.2f}  {pb:7.3f}  "
                        f"{'yes' if pb > 0 else 'no'}")
        return "\n".join(rows)


def timeit_median(fn, *args, reps: int = 5,
                  device: torch.device = torch.device("cpu")) -> float:
    """Median wall time of ``fn(*args)``, each call ended by a
    synchronize of ``device`` (the reference's ``block_until_ready``).
    One warm-up call first, as the reference makes; its queued work is
    waited for before the first timed call."""
    fn(*args)
    synchronize(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]
