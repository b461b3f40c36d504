"""One device's program of a grid: the dry run's counterpart of XLA's
SPMD partitioner.

The reference's dry run compiles the program one device of the grid
runs: GSPMD partitions every op by its operands' shardings and adds the
collectives the partitioned program needs (``launch/hlo_utils.py``).
The port's counterpart is DTensor: ``fake_grid`` brings up a process
group of the grid's size whose collectives move nothing (PyTorch's
``fake`` backend, this process its rank 0) and a ``DeviceMesh`` of the
grid's shape and axis names over it. ``sharding/rules.py::place`` puts
a step's arguments on that mesh by the sharding rules as DTensors, each
holding its rank-0 shard as its local tensor, and running the step on
them runs one device's program: DTensor splits every op by its
operands' placements into the local op and the collectives that op
needs, which ``cost_utils.StepCounter(per_device=True)`` counts.

The fake backend lives in ``torch.testing._internal.distributed
.fake_pg``, a private module: this is the one module of the port that
imports it. It runs on torch 2.13 (the CPU tests) and 2.11 with CUDA
12.8 (the card's machine, ``chip_smoke.py``'s ``[dryrun] spmd`` line).
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch.distributed as dist


@contextlib.contextmanager
def fake_grid(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` and ``axis_names`` (a
    ``ModelMesh``'s, e.g. ``(16, 16)`` and ``("data", "model")``) over a
    fake process group of ``prod(shape)`` ranks, this process rank 0.
    Plain tensors that meet DTensors inside count as replicated (DTensor's
    ``implicit_replication``), as a constant does under GSPMD. Raises if
    a process group is already up; destroys the fake one on exit, so
    nothing after the block sees a group. ``device_type`` is that of the
    local tensors' device (``cpu`` serves ``meta`` tensors): on a ``cpu``
    grid DTensor stands a gather and a chunk in for each all-to-all
    (gloo has none), so the block routes DTensor's all-to-all to its own
    collective op, as on a ``cuda`` grid."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_grid: a process group is already up; the "
                           "per-device count needs the process to itself")
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    dist.init_process_group("fake", rank=0, world_size=math.prod(shape),
                            store=FakeStore())
    try:
        mesh = init_device_mesh(device_type, shape,
                                mesh_dim_names=axis_names)
        with implicit_replication(), _alltoall_on_cpu(), \
                _bookkeeping_unseen():
            yield mesh
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _bookkeeping_unseen():
    """DTensor works out shard sizes and offsets with tensor ops of its
    own (``arange``, ``cat``) while it decides an op's sharding and plans
    a move, and caches both: those ops would run only the first time in
    the process. The block decides and plans with the dispatch modes set
    aside, so no counter sees that bookkeeping and a count does not
    depend on what ran before it."""
    from torch.distributed.tensor import DTensor, _redistribute
    from torch.utils._python_dispatch import _disable_current_modes

    def unseen(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run
    patches = [(_redistribute, "_gen_transform_infos"),
               (DTensor._op_dispatcher,
                "_propagate_op_sharding_dispatch_slow_path")]
    saved = [(obj, name, vars(obj).get(name), getattr(obj, name))
             for obj, name in patches if hasattr(obj, name)]
    for obj, name, _, fn in saved:
        setattr(obj, name, unseen(fn))
    try:
        yield
    finally:
        for obj, name, own, _ in saved:
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)


@contextlib.contextmanager
def _alltoall_on_cpu():
    """DTensor's ``Shard(i) → Shard(j)`` move as its ``all_to_all`` op on
    a ``cpu`` grid too (``_dtensor.shard_dim_alltoall``, which has a meta
    kernel), not the gather and chunk it stands in for gloo. Where torch
    keeps the helper elsewhere the stand-in stays, counted as gathers."""
    import torch
    from torch.distributed.tensor import placement_types

    saved = getattr(placement_types, "shard_dim_alltoall", None)
    if saved is None or not hasattr(torch.ops._dtensor,
                                    "shard_dim_alltoall"):
        yield
        return

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


def grid_of(model_mesh, device_type: str = "cpu"):
    """``fake_grid`` over a ``ModelMesh``'s shape and axis names."""
    return fake_grid(tuple(model_mesh.shape.values()),
                     model_mesh.axis_names, device_type)
