"""The model's mesh (the reference's ``launch/mesh.py``): a named grid of
devices driven by one controller.

``ModelMesh`` is the counterpart of ``jax.sharding.Mesh``: ``axis_names``
such as ``("data", "model")``, a ``devices`` grid of ``torch.device``
(a numpy object array of the mesh's shape) and ``shape``, an ordered
name → size mapping, so ``mesh.shape.get("model", 1)`` reads the same in
both packages. One process drives every slot of the grid, as the
reference drives its mesh from one process through ``shard_map``: no
``torch.distributed``, but for the dry run's count of one device's
program of a grid (``launch/spmd.py``), which runs on a fake process
group and moves no data. A slot may repeat a device, which is how a mesh
runs on one card, as ``--xla_force_host_platform_device_count`` runs it
on one JAX host. A one-axis ``ModelMesh`` describes what
``core/shard.py``'s ``StoreMesh`` describes (an ordered tuple of devices
on one named axis); the store keeps its own class.

``make_production_mesh`` is the dry run's device grid
(``launch/dryrun.py``): 256 or 512 slots on the ``meta`` device, where
a step runs on shapes alone. ``use_mesh`` is the reference's
ambient-mesh context, which one controller does not need.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class ModelMesh:
    """A named grid of devices. ``devices=None`` makes an abstract mesh
    (``abstract_mesh``): its shape serves the sharding rules' math, and
    anything that would place a tensor on it raises."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes repeat a name: {axis_names}")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh axes must have size >= 1: {shape}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self._devices = None
        if devices is not None:
            flat = [indexed_device(torch.device(d))
                    for d in np.asarray(devices, dtype=object).reshape(-1)]
            if len(flat) != int(np.prod(shape)):
                raise ValueError(f"{len(flat)} devices for a mesh of shape "
                                 f"{shape}")
            grid = np.empty(len(flat), dtype=object)
            grid[:] = flat
            self._devices = grid.reshape(shape)

    @property
    def abstract(self) -> bool:
        return self._devices is None

    @property
    def devices(self) -> np.ndarray:
        if self._devices is None:
            raise RuntimeError(
                "an abstract mesh has no devices: build one with "
                "make_host_mesh to place tensors on it")
        return self._devices

    @property
    def lead(self) -> torch.device:
        """The device of the grid's first slot: where the layers that are
        not sharded run, and where inputs come from and outputs land."""
        return self.devices.flat[0]

    def device(self, **coords) -> torch.device:
        """The device at ``coords`` (axis name → index; an axis left out
        is at 0)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh "
                             f"{self.axis_names}")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        if self.abstract:
            return f"ModelMesh({axes}, abstract)"
        devs = sorted(set(map(str, self._devices.flat)))
        return f"ModelMesh({axes}, devices={devs})"


def indexed_device(dev: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current>``: tensors report an indexed device,
    so the grid holds indexed ones and compares equal to them."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def abstract_mesh(**axes) -> ModelMesh:
    """Device-free mesh for rule and spec math (tests, dry analysis)."""
    return ModelMesh(tuple(axes.values()), tuple(axes.keys()))


def dp_axes_of(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> ModelMesh:
    """A ``(data, model)`` mesh with every slot on one device: the card
    (``device=None``; raises when there is none) or ``device``. The mesh's
    math (capacities, exchanges, partial sums) runs there in full. It
    never spreads over several cards: ``moe_apply_ep`` would then copy
    each shard's expert blocks to its card on every call, since the
    experts are not yet held resident on distinct cards (ROADMAP)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device is available; "
                           "pass device='cpu' for a mesh on the CPU")
    return ModelMesh((data, model), ("data", "model"),
                     [dev] * (int(data) * int(model)))


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> ModelMesh:
    """The production grids of the dry run: ``(data=16, model=16)``, 256
    devices, or ``(pod=2, data=16, model=16)``, 512, every slot on
    ``device``. No machine this code runs on holds 256 cards: the dry
    run is analysis on the host, a step run on ``meta`` tensors
    (shapes and dtypes, no storage), not an entry point for a card. The
    ``pod`` axis composes with ``data`` (``dp_axes_of``) for the batch
    and FSDP shardings."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ModelMesh(shape, axes,
                     [torch.device(device)] * int(np.prod(shape)))


def use_mesh(mesh):
    """The reference's ambient-mesh context (``jax.set_mesh``). One
    controller places every tensor itself and reads no ambient mesh, so
    this is a ``contextlib.nullcontext``: callers keep the reference's
    ``with use_mesh(mesh):`` shape."""
    return contextlib.nullcontext(mesh)
