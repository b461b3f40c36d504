"""A step's cost, counted on ``meta`` tensors: the port's counterpart of
the reference's ``launch/hlo_utils.py``, which reads XLA's
``cost_analysis``, ``memory_analysis`` and the compiled HLO's
collectives.

``StepCounter`` is a ``TorchDispatchMode`` run around a step whose
arguments are meta tensors (``launch/steps.py::build_step``). Every
ATen op the step dispatches, the backward's and an optimizer's
included, adds to:

* ``flops`` — the formulas ``torch.utils.flop_counter`` registers
  (matmuls, convolutions, attention): the multiply-adds of the tensor
  products, as ``FlopCounterMode`` counts them. Elementwise ops add
  nothing, where XLA's ``flops`` counts them too.
* ``bytes`` — each op's input and output bytes by shape, view ops
  excepted (XLA's "bytes accessed": every instruction's operands and
  result).
* ``transcendentals`` — the elements produced by the ops in
  ``TRANSCENDENTAL`` (exp, log, tanh, sigmoid, erf, rsqrt, sin, cos,
  pow, and the fused ops built on them: softmax, log-softmax, SiLU,
  GELU).
* ``peak_bytes`` — the most bytes live at once: the held arguments plus
  every storage still referenced after an op, a storage counted once
  across its views, autograd's saved tensors included (they hold their
  storage), remat's freed activations gone when freed. A finalizer on
  each storage takes its bytes off the live total the moment it dies,
  so a tensor dies on ``meta`` when it would die on the card, and an op
  costs the same however many storages are live (a step that saves a
  tensor a time step of a 32,768-step recurrence holds ~10^5).
  ``phase_peaks`` splits it by the step's phase: ``"before"`` its
  backward, ``"backward"`` (inside the autograd engine, remat's
  recompute included) and ``"after"`` it (an optimizer's update).

``collectives`` counts the exchanges the port itself performs, which
on one controller are the only ones: ``models/moe.py``'s ``all_to_all``
(``_ALL_TO_ALL``, through ``_exchange``), forward and backward, and the
``model``-axis partial sum ``_ff_sum`` (forward). GSPMD's implicit
collectives (gradient reductions, FSDP gathers) do not exist in a
one-controller program, so the count covers explicit exchanges only;
its bytes are summed over the mesh's shards, where the reference's
HLO holds one device's program. Nothing compares it with the
reference's figure.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import moe
from repro_torch.sharding.rules import _axis_size

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
TRANSCENDENTAL = {
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log2, _aten.log1p,
    _aten.tanh, _aten.sigmoid, _aten.erf, _aten.rsqrt, _aten.sin,
    _aten.cos, _aten.pow, _aten._softmax, _aten._log_softmax, _aten.silu,
    _aten.gelu, _aten.silu_backward, _aten.gelu_backward,
}

# a Python scalar leaf (an optimizer's step count) is the reference's
# int32 scalar argument
SCALAR_BYTES = 4


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of an array of ``shape`` in ``dtype`` (the reference's
    ``shape_bytes`` reads the same from an HLO shape string)."""
    return math.prod(shape) * dtype.itemsize


def _nbytes(t: torch.Tensor) -> int:
    return shape_bytes(t.shape, t.dtype)


def _leaves(x):
    """The leaves of nested dicts, lists and tuples, ``None`` skipped."""
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        if x is not None:
            yield x
        return
    for v in x:
        yield from _leaves(v)


def _tensors(x):
    return (t for t in _leaves(x) if isinstance(t, torch.Tensor))


class _Counted(torch.autograd.Function):
    """Identity that records one exchange of ``x`` on the way forward and
    one of its gradient on the way back."""

    @staticmethod
    def forward(ctx, x, counter, kind):
        ctx.counter, ctx.kind = counter, kind
        counter.exchange(kind, _nbytes(x))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.counter.exchange(ctx.kind, _nbytes(g))
        return g, None, None


class StepCounter(TorchDispatchMode):
    """Counts what a step on meta tensors computes, moves and holds (see
    the module docstring). ``held`` are the trees live when the step
    starts (its arguments): their storages count toward ``peak_bytes``
    from the start, and ``base_bytes`` is their total. ``run(fn, *args)``
    runs ``fn`` under the counter and keeps its output in ``out``."""

    def __init__(self, *held):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}
        self.out = None
        self._live: Dict[int, int] = {}       # storage cdata → nbytes
        self._cur = 0                          # bytes of the live storages
        for t in _tensors(held):
            self._track(t)
        self.base_bytes = self._cur
        self.peak_bytes = self._cur
        self.phase_peaks = {"before": self._cur}
        self._after_backward = False

    # -- liveness -----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        # a storage's Python object lives exactly as long as the storage
        # (PyTorch preserves it), so this runs when the storage dies
        weakref.finalize(st, self._died, key).atexit = False

    def _died(self, key: int) -> None:
        self._cur -= self._live.pop(key)

    @property
    def live_bytes(self) -> int:
        """Bytes live now."""
        return self._cur

    # -- the exchanges --------------------------------------------------------
    def exchange(self, kind: str, nbytes: int) -> None:
        self.collectives[kind] += nbytes
        self.collective_counts[kind] += 1

    def __enter__(self):
        self._saved = (moe._ALL_TO_ALL, moe._ff_sum)
        a2a, ff_sum = self._saved

        def all_to_all(bufs, devices):
            return [_Counted.apply(r, self, "all-to-all")
                    for r in a2a(bufs, devices)]

        def partial_sum(lay, s, experts, x, eq):
            y = ff_sum(lay, s, experts, x, eq)
            if len(experts) > 1:
                self.exchange("all-reduce", _nbytes(y))
            return y
        moe._ALL_TO_ALL, moe._ff_sum = all_to_all, partial_sum
        return super().__enter__()

    def __exit__(self, *exc):
        moe._ALL_TO_ALL, moe._ff_sum = self._saved
        return super().__exit__(*exc)

    def run(self, fn, *args):
        with self:
            self.out = fn(*args)
        return self.out

    # -- every op -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        outs = ([out] if isinstance(out, torch.Tensor)
                else list(_tensors(out)))
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if packet in TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if func.is_view:                # no bytes move, no storage is made
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        for t in outs:
            self.bytes += _nbytes(t)
            self._track(t)
        if torch._C._current_graph_task_id() != -1:
            phase, self._after_backward = "backward", True
        else:
            phase = "after" if self._after_backward else "before"
        if self._cur > self.phase_peaks.get(phase, 0):
            self.phase_peaks[phase] = self._cur
            self.peak_bytes = max(self.peak_bytes, self._cur)
        return out


def collective_bytes(counter: StepCounter) -> Dict[str, int]:
    """The reference's record of a step's collectives: bytes per kind,
    ``total`` and ``counts`` (explicit exchanges only; see the module
    docstring)."""
    out: Dict[str, object] = dict(counter.collectives)
    out["total"] = sum(counter.collectives.values())
    out["counts"] = dict(counter.collective_counts)
    return out


def shard_bytes(leaf, sharding) -> int:
    """Bytes one device holds of ``leaf`` under ``sharding``: each dim
    divided by the size of the mesh axes its spec entry names (the rules
    shard only dims that divide). A Python scalar is the reference's
    int32 scalar."""
    if not isinstance(leaf, torch.Tensor):
        return SCALAR_BYTES
    spec = tuple(sharding.spec) + (None,) * leaf.ndim
    return shape_bytes([-(-dim // _axis_size(sharding.mesh, ax)) if ax
                        else dim for dim, ax in zip(leaf.shape, spec)],
                       leaf.dtype)


def device_bytes(trees, shardings) -> int:
    """Bytes one device holds of every leaf of ``trees`` (a sequence of
    trees) under the matching ``shardings``."""
    total = 0
    for tree, sh in zip(trees, shardings):
        if isinstance(tree, dict):
            total += device_bytes([tree[k] for k in tree],
                                 [sh[k] for k in tree])
        elif tree is not None:
            total += shard_bytes(tree, sh)
    return total


def _whole(trees) -> int:
    return sum(_nbytes(t) if isinstance(t, torch.Tensor) else SCALAR_BYTES
               for t in _leaves(trees))


def cost_summary(counter: StepCounter, built, *, donate: bool = False
                 ) -> Dict[str, float]:
    """The reference's ``cost_summary`` keys for a step ``counter`` ran
    (``counter.run(built["fn"], *built["args"])``):

    * ``flops``, ``bytes``, ``transcendentals``: the whole step, every
      shard of the mesh (see the module docstring);
    * ``arg_bytes``, ``out_bytes``: one device's share, each leaf's shard
      under ``in_shardings`` / ``out_shardings``;
    * ``alias_bytes``: one device's share of the donated arguments (the
      params and optimizer state of a train step, a decode step's
      caches) when ``donate``;
    * ``peak_bytes``: the one-controller step's peak of live bytes, which
      is what a (1, 1) mesh holds on one device: it is not divided over
      the grid;
    * ``temp_bytes``: that peak above the step's whole arguments and
      outputs.
    """
    args, out = built["args"], counter.out
    out = out if isinstance(out, tuple) else (out,)
    out_sh = built["out_shardings"]
    out_sh = out_sh if isinstance(out_sh, tuple) else (out_sh,)
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "transcendentals": float(counter.transcendentals),
        "out_bytes": device_bytes(out, out_sh),
        "temp_bytes": max(0, counter.peak_bytes - _whole(args)
                          - _whole(out)),
        "peak_bytes": int(counter.peak_bytes),
        **arg_summary(built, donate=donate),
    }


def arg_summary(built, *, donate: bool = False) -> Dict[str, int]:
    """``cost_summary``'s ``arg_bytes`` and ``alias_bytes``: they read
    the built step's arguments and shardings alone, not a run."""
    args = built["args"]
    kind = built["meta"]["kind"]
    donated = ()
    if donate:
        donated = (0, 1) if kind == "train" else (
            (2,) if kind == "decode" else ())
    return {
        "arg_bytes": device_bytes(args, built["in_shardings"]),
        "alias_bytes": device_bytes([args[i] for i in donated],
                                   [built["in_shardings"][i]
                                    for i in donated]),
    }
