"""Training loop (the reference's ``train/trainer.py``) in eager
PyTorch: ``torch.autograd`` over the params tree, grad accumulation over
a leading micro-batch axis, the cosine LR schedule and periodic
checkpoints, on the model's device.

A step reads nothing back from the device: the LR comes from the
schedule on the host, the optimizers keep their step count on the host,
and the loss is read only at a log step. A model built over a mesh
(``Model(mesh=...)``) trains through its expert-parallel MoE layers.

``donate`` is the reference's XLA buffer donation: with ``donate=True``
(the default) a step hands the caller's params and optimizer-state
tensors the updated values in place (``Tensor.set_``: the caller's
tensor objects take the new storage, the old is freed once nothing else
holds it), so the trees passed in ARE the trees returned. With
``donate=False`` the trees passed in are left unchanged. The values are
the same either way. The reference's ``in_shardings`` is not taken: its
own ``jax.jit`` does not pass it on, and one controller places nothing
but the MoE layers' expert blocks, which ``Model(mesh=...)`` decides.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import torch

from repro_torch.optim import make_optimizer
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.sharding.rules import is_sharded
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.tree import flat_params, nest_params, tree_map

LOSSES = ("lm", "classify")


@dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    grad_accum: int = 1
    optimizer: str = "adamw"
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_path: str = "checkpoints/model"
    loss: str = "lm"            # lm | classify


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of the params tree (the tree's structure; a
    leaf the loss does not reach, such as the LM head under
    ``classify_loss``, gets zeros, as the reference's grads have)."""
    flat = flat_params(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss = loss_fn(nest_params(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else _placed_as(g, v)
             for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), nest_params(grads)


def _placed_as(g, p):
    """A gradient on one device's program of a grid (DTensors) in its
    param's placements, as XLA reduces it in the backward in the grad's
    own dtype; any other gradient as it is."""
    if not is_sharded(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


@torch.no_grad()
def _donate(old, new):
    """Give every tensor of the tree ``old`` the value of its counterpart
    in ``new`` (its storage), and every other leaf (an optimizer's step
    count) its new value, in place."""
    for k, v in new.items():
        if isinstance(v, dict):
            _donate(old[k], v)
        elif isinstance(v, torch.Tensor):
            old[k].set_(v)
        else:
            old[k] = v


class Trainer:
    def __init__(self, model, tcfg: TrainConfig, *, donate: bool = True):
        if tcfg.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got "
                             f"{tcfg.loss!r}")
        self.model = model
        self.tcfg = tcfg
        self.donate = donate
        self._opt_init, self._opt_update = make_optimizer(tcfg.optimizer)
        self.loss_fn = (model.train_loss if tcfg.loss == "lm"
                        else model.classify_loss)

    def init_opt(self, params):
        return self._opt_init(params)

    def value_and_grad(self, params, batch):
        """(loss, grads) of one step's batch. With ``grad_accum > 1``
        every array of ``batch`` has a leading micro-batch axis of that
        length: the micro-batches' losses and grads are summed, then
        divided by it."""
        n = self.tcfg.grad_accum
        if n <= 1:
            return value_and_grad(self.loss_fn, params, batch)
        loss, grads = None, None
        for j in range(n):
            lj, gj = value_and_grad(self.loss_fn, params,
                                    {k: v[j] for k, v in batch.items()})
            if grads is None:
                loss, grads = lj, gj
            else:
                loss = loss + lj
                grads = tree_map(torch.add, grads, gj)
        return loss / n, tree_map(lambda g: g / n, grads)

    def step(self, params, opt_state, batch, step_idx: int):
        """One optimizer step; returns (params, opt_state, loss). Under
        ``donate`` the returned trees are ``params`` and ``opt_state``
        themselves, updated in place."""
        tc = self.tcfg
        lr = float(cosine_schedule(step_idx, tc.warmup, tc.steps, tc.lr))
        loss, grads = self.value_and_grad(params, batch)
        new_params, new_opt = self._opt_update(
            params, grads, opt_state, lr=lr, weight_decay=tc.weight_decay,
            grad_clip=tc.grad_clip)
        if not self.donate:
            return new_params, new_opt, loss
        del grads
        _donate(params, new_params)
        _donate(opt_state, new_opt)
        return params, opt_state, loss

    def fit(self, params, batches: Iterator[dict], *, opt_state=None,
            on_log: Optional[Callable] = None):
        """Train for ``steps`` batches of ``batches``; returns (params,
        opt_state, history of (step, loss) at the log steps)."""
        tc = self.tcfg
        if opt_state is None:
            opt_state = self.init_opt(params)
        history = []
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            if i >= tc.steps:
                break
            batch = {k: torch.as_tensor(v, device=self.model.device)
                     for k, v in batch.items()}
            params, opt_state, loss = self.step(params, opt_state, batch, i)
            if i % tc.log_every == 0 or i == tc.steps - 1:
                lv = float(loss)
                dt = time.perf_counter() - t0
                history.append((i, lv))
                (on_log or print)(f"step {i:5d}  loss {lv:8.4f}  "
                                  f"{dt:6.1f}s")
            if tc.ckpt_every and i and i % tc.ckpt_every == 0:
                save_checkpoint(f"{tc.ckpt_path}_{i}.npz", params, step=i)
        return params, opt_state, history
