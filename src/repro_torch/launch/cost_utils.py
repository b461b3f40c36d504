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
one-controller program, so this count covers explicit exchanges only,
its bytes summed over the mesh's shards.

``StepCounter(per_device=True)`` counts one device's program of the
grid instead, as the reference's partitioned HLO describes it: the
step's arguments are DTensors on a fake grid (``launch/spmd.py``,
``sharding/rules.py::place``). A DTensor op reaches the counter first
at its global shapes; the counter lets DTensor split it and counts
what DTensor then runs on the local tensors: each local op's FLOPs,
bytes and transcendentals, liveness on the local storages, and every
collective DTensor issues (inside an op's dispatch too: a ``Partial``
resolved, an argument redistributed) by the reference's ``COLLECTIVES``
kind, its result's bytes as ``hlo_utils.collective_bytes`` reads them
from the HLO. DTensor's own shape inference runs ops on fake tensors at
the global shapes; those are not counted. An op DTensor has no
sharding strategy for (or cannot split without an exchange it will
not make) runs as GSPMD runs an op it cannot partition: its DTensor
arguments gathered to ``Replicate`` one mesh axis at a time until
DTensor splits it (at worst the op runs whole on every device), those
all-gathers counted; ``fallbacks`` counts those ops by name.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
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

# DTensor's collectives (``torch.distributed._functional_collectives``)
# by the reference's kind; ``wait_tensor`` and the autograd wrapper do
# no work of their own
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_FUNCOL_NOOP = {"wait_tensor", "_wrap_tensor_autograd"}
# what DTensor raises where it cannot split an op: no strategy, a view
# it will not split without an exchange, a strategy that rejects the
# arguments' layout (torch 2.11's ``index_put``), a strategy whose
# placements do not cover the mesh (torch 2.11's ``constant_pad_nd``)
_UNSPLIT = (NotImplementedError, RuntimeError, AssertionError, IndexError)


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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (this device's shard), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _in_shape_inference() -> bool:
    """DTensor infers an op's global output shape by running it on fake
    tensors under a ``FakeTensorMode``."""
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


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

    def __init__(self, *held, per_device: bool = False):
        super().__init__()
        self.per_device = per_device
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}
        self.fallbacks: Dict[str, int] = {}
        self.out = None
        self._live: Dict[int, int] = {}       # storage cdata → nbytes
        self._cur = 0                          # bytes of the live storages
        self._splitting = False                # inside a DTensor op
        if per_device:
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor
        for t in _tensors(held):
            self._track(_local(t))
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
        if self.per_device:
            return super().__enter__()
        self._saved = (moe._ALL_TO_ALL, moe._ff_sum)
        a2a, ff_sum = self._saved

        def all_to_all(bufs, devices):
            got = a2a(bufs, devices)
            if len(bufs) < 2:           # a group of one exchanges nothing
                return got
            return [_Counted.apply(r, self, "all-to-all") for r in got]

        def partial_sum(lay, s, experts, x, eq):
            y = ff_sum(lay, s, experts, x, eq)
            if len(experts) > 1:
                self.exchange("all-reduce", _nbytes(y))
            return y
        moe._ALL_TO_ALL, moe._ff_sum = all_to_all, partial_sum
        return super().__enter__()

    def __exit__(self, *exc):
        if not self.per_device:
            moe._ALL_TO_ALL, moe._ff_sum = self._saved
        return super().__exit__(*exc)

    def run(self, fn, *args):
        with self:
            self.out = fn(*args)
        return self.out

    # -- every op -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.per_device:
            if any(issubclass(t, self._dtensor) for t in types):
                return self._split(func, args, kwargs)
            if _in_shape_inference():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if self.per_device and func.namespace != "aten":
            name = func._opname
            if name in _FUNCOL_NOOP:
                return out
            kind = _FUNCOL_KIND.get(name)
            if kind is not None:
                self.exchange(kind, sum(_nbytes(t) for t in
                                        ([out] if isinstance(out, torch.Tensor)
                                         else _tensors(out))))
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

    def _split(self, func, args, kwargs):
        """A DTensor op: DTensor splits it into local ops and collectives,
        which come back to this mode; the mode steps aside for the op
        itself (``NotImplemented`` hands it to DTensor with the mode still
        active). An op DTensor cannot split runs replicated."""
        if self._splitting:
            return NotImplemented
        self._splitting = True
        try:
            with self:
                try:
                    return func(*args, **kwargs)
                except _UNSPLIT:
                    name = str(func)
                    self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
                    return _replicated(func, args, kwargs)
        finally:
            self._splitting = False


def _replicated(func, args, kwargs):
    """``func`` where DTensor cannot split it as its arguments lie: the
    arguments' mesh axes gathered to ``Replicate`` one at a time, the
    last first, until DTensor splits it (the gathers issued by DTensor,
    so counted); with every axis gathered and still no strategy, run on
    the local tensors, its tensor outputs replicated DTensors."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in _leaves((args, kwargs))
                if isinstance(t, DTensor))

    def gather(x, axis):
        if isinstance(x, DTensor):
            pl = list(x.placements)
            pl[axis] = Replicate()
            return x.redistribute(mesh, pl)
        if isinstance(x, (list, tuple)):
            return type(x)(gather(v, axis) for v in x)
        return x
    for axis in reversed(range(mesh.ndim)):
        args = gather(args, axis)
        kwargs = {k: gather(v, axis) for k, v in kwargs.items()}
        try:
            return func(*args, **kwargs)
        except _UNSPLIT:
            pass

    def local(x):
        if isinstance(x, DTensor):
            return x.to_local()
        if isinstance(x, (list, tuple)):
            return type(x)(local(v) for v in x)
        return x
    out = func(*local(args), **{k: local(v) for k, v in kwargs.items()})
    rep = [Replicate()] * mesh.ndim

    def wrap(x):
        if isinstance(x, torch.Tensor):
            return DTensor.from_local(x, mesh, rep, run_check=False)
        if isinstance(x, (list, tuple)):
            return type(x)(wrap(v) for v in x)
        return x
    return wrap(out)


def collective_bytes(counter: StepCounter) -> Dict[str, int]:
    """The reference's record of a step's collectives: bytes per kind,
    ``total`` and ``counts`` (one device's, or one controller's explicit
    exchanges; see the module docstring)."""
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
    """Bytes the leaves of ``trees`` hold where the step runs: a DTensor
    its local tensor's."""
    return sum(_nbytes(_local(t)) if isinstance(t, torch.Tensor)
               else SCALAR_BYTES for t in _leaves(trees))


def cost_summary(counter: StepCounter, built, *, donate: bool = False
                 ) -> Dict[str, float]:
    """The reference's ``cost_summary`` keys for a step ``counter`` ran
    (``counter.run(built["fn"], *built["args"])``):

    * ``flops``, ``bytes``, ``transcendentals``: one device's program
      with ``per_device``, else the whole step, every shard of the mesh
      (see the module docstring);
    * ``arg_bytes``, ``out_bytes``: one device's share, each leaf's shard
      under ``in_shardings`` / ``out_shardings``;
    * ``alias_bytes``: one device's share of the donated arguments (the
      params and optimizer state of a train step, a decode step's
      caches) when ``donate``;
    * ``peak_bytes``: the most bytes live at once: on one device of the
      grid with ``per_device``; else the one-controller step's, which is
      what a (1, 1) mesh holds on one device;
    * ``temp_bytes``: that peak above the arguments and outputs it holds
      (one device's shards with ``per_device``).
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
