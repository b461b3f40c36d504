"""The port's training losses against the JAX package's: ``Model.train_loss``
for every arch and ``classify_loss``, with their grads; ``remat``; and
the refusal to differentiate through the kernels
(``tests/test_torch_trainer.py`` holds ``Trainer``).

Tolerances:
* losses within 1e-5 relative and grads, per leaf, within
  1e-4·max|g_ref| + 1e-7: f32 forward and backward passes summed in
  another order, compounded over the layers and a vocab-wide head
  (measured: ≤ 2e-6 for every arch but rwkv6_3b). rwkv6_3b's are held
  within 5e-4·max|g_ref| + 1e-7: its time-mix grads are ill-conditioned
  in f32, and both packages' f32 grads differ from an f64 run of the
  port by up to 3.8e-4 of max|g| (measured on this test's batch);
* where a router picks experts, the port runs on the reference's picks
  (each MoE router call takes the ids the reference's unrolled forward
  picked, weighted by the port's own probabilities at them, as
  chip_smoke's ``ForcedRoutes`` does), so every token is compared; the
  picks of the port's own that differ are counted and printed;
* ``remat=True`` equals ``remat=False`` exactly: on the CPU the
  recomputed forward is the same arithmetic.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import flat_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
GRAD_RTOL_ARCH = {"rwkv6_3b": 5e-4}


def _batch(cfg, seed, n=B, classes=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)}
    if cfg.encoder is not None:
        e = cfg.encoder
        b["frames"] = rng.standard_normal(
            (n, e.n_frames, e.d_model)).astype(np.float32)
    if classes:
        b["labels"] = rng.integers(0, classes, n).astype(np.int32)
    return b


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _params(cfg, seed):
    """Random params of ``cfg`` made by the port (the reference's layout,
    so the same numpy tree feeds both packages): JAX's op-by-op init
    would take seconds an arch."""
    return _np_tree(build_model(cfg, device=CPU).init(seed))


def _reference_ids(jcfg, jp, batch):
    """The expert ids (T, k) of each MoE router call of the reference's
    unrolled forward, in call order (empty without a MoE)."""
    if jcfg.moe is None:
        return []
    import repro.models.moe as jmoe
    jm, real = jax_build_model(jcfg, layer_loop="unroll"), jmoe._router

    def picks(p, b):
        ids = []

        def router(x, w, k):
            out = real(x, w, k)
            ids.append(out[2])
            return out
        jmoe._router = router
        try:
            jm.forward(p, b)
        finally:
            jmoe._router = real
        return ids
    ids = jax.jit(picks)(jp, jax.tree.map(jnp.asarray, batch))
    return [torch.from_numpy(np.asarray(i).astype(np.int64)) for i in ids]


class ForcedRoutes:
    """While active, the i-th port router call takes ``ids[i]`` in place of
    its own top-k (weights: its own probabilities there, renormalised);
    ``moved`` counts the (token, call) picks of its own that differed."""

    def __init__(self, ids):
        self.ids, self.n, self.moved = list(ids), 0, 0

    def __enter__(self):
        import repro_torch.models.moe as moe_mod
        self.mod, self.real = moe_mod, moe_mod._router

        def router(x, w, k):
            probs, _, own, _ = self.real(x, w, k)
            ids = self.ids[self.n]
            self.n += 1
            weights = probs.gather(1, ids)
            weights = weights / weights.sum(-1, keepdim=True)
            self.moved += int((own.sort(-1).values != ids.sort(-1).values)
                              .any(-1).sum())
            assign = probs.new_zeros(probs.shape).scatter_(1, ids, 1.0)
            aux = probs.shape[-1] * (assign.mean(0) / k
                                     * probs.mean(0)).sum()
            return probs, weights.to(x.dtype), ids, aux
        moe_mod._router = router
        return self

    def __exit__(self, *exc):
        self.mod._router = self.real


@pytest.fixture(scope="module")
def refs():
    """Per arch (built on first use): the reference's reduced params,
    batch, ``train_loss`` and its grads, and its router picks."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_get_reduced(arch)
            jm = jax_build_model(jcfg)
            jp = jax.tree.map(jnp.asarray, _params(get_reduced(arch), 1))
            batch = _batch(jcfg, 0)
            loss, grads = jax.jit(jax.value_and_grad(jm.train_loss))(
                jp, jax.tree.map(jnp.asarray, batch))
            cache[arch] = dict(params=_np_tree(jp), batch=batch,
                               loss=float(loss), grads=_np_tree(grads),
                               ids=_reference_ids(jcfg, jp, batch))
        return cache[arch]
    return get


def _hold_grads(grads, ref_grads, rtol=GRAD_RTOL, prefix=""):
    """Per leaf, max|Δg| ≤ rtol·max|g_ref| + GRAD_ATOL."""
    assert sorted(grads) == sorted(ref_grads), prefix
    for k, r in ref_grads.items():
        if isinstance(r, dict):
            _hold_grads(grads[k], r, rtol, f"{prefix}/{k}")
            continue
        gap = float(np.max(np.abs(grads[k].numpy() - r)))
        tol = rtol * float(np.max(np.abs(r))) + GRAD_ATOL
        assert gap <= tol, (f"{prefix}/{k}", gap, tol)


def _port_loss_grads(arch, ref, remat=False):
    model = build_model(get_reduced(arch), device=CPU, remat=remat)
    params = tree_to_torch(ref["params"], CPU)
    routes = ForcedRoutes(ref["ids"]) if ref["ids"] else None
    with routes or contextlib.nullcontext():
        loss, grads = value_and_grad(model.train_loss, params, ref["batch"])
    if routes is not None:
        assert routes.n == len(ref["ids"])
        print(f"{arch}: {routes.moved} router picks of the port's own "
              f"differ from the reference's over {routes.n} calls")
    return loss, grads


# the dense archs here, the rest of the zoo in test_torch_train_zoo.py
DENSE = ["gpt2_small", "bert_base", "qwen2_1_5b", "qwen3_8b", "deepseek_7b",
         "chameleon_34b"]
ZOO = [a for a in ARCH_IDS if a not in DENSE]


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_grads_match_reference(arch, refs):
    ref = refs(arch)
    loss, grads = _port_loss_grads(arch, ref)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    _hold_grads(grads, ref["grads"], GRAD_RTOL_ARCH.get(arch, GRAD_RTOL))


@pytest.mark.parametrize("arch", ["gpt2_small", "dbrx_132b",
                                  "recurrentgemma_2b", "whisper_medium"])
def test_remat_equals_no_remat(arch):
    """Remat recomputes each layer (for MoE, its routing too) in the
    backward pass: the same loss and grads."""
    cfg = get_reduced(arch)
    ref = dict(params=_params(cfg, 1), batch=_batch(cfg, 0), ids=[])
    loss, grads = _port_loss_grads(arch, ref)
    loss_r, grads_r = _port_loss_grads(arch, ref, remat=True)
    assert torch.equal(loss, loss_r)
    flat = flat_params(grads)
    for k, g in flat_params(grads_r).items():
        assert torch.equal(g, flat[k]), k


def test_remat_frees_activations():
    """Under remat a layer's activations are not kept for the backward
    pass: fewer tensors are saved by autograd."""
    cfg = get_reduced("gpt2_small")
    batch = _batch(cfg, 1)

    def saved(remat):
        model = build_model(cfg, device=CPU, remat=remat)
        params = model.init(0)
        n = [0]

        def pack(t):
            n[0] += t.numel()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            value_and_grad(model.train_loss, params, batch)
        return n[0]
    assert saved(True) < 0.5 * saved(False)


def test_classify_loss_and_grads_match_reference():
    jcfg = jax_get_reduced("bert_base").replace(n_classes=4)
    cfg = get_reduced("bert_base").replace(n_classes=4)
    params = _params(cfg, 2)
    batch = _batch(jcfg, 3, classes=4)
    jl, jg = jax.jit(jax.value_and_grad(jax_build_model(jcfg).classify_loss))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    loss, grads = value_and_grad(build_model(cfg, device=CPU).classify_loss,
                                 tree_to_torch(params, CPU), batch)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _hold_grads(grads, _np_tree(jg))


def test_kernel_attn_impl_refuses_to_differentiate():
    cfg = get_reduced("gpt2_small").replace(n_classes=4)
    model = build_model(cfg, device=CPU, attn_impl="kernel")
    params = model.init(0)
    batch = _batch(cfg, 0, classes=4)
    for loss_fn in (model.train_loss, model.classify_loss):
        with pytest.raises(NotImplementedError, match="no gradient"):
            loss_fn(params, batch)
    tr = Trainer(model, TrainConfig(steps=1))
    with pytest.raises(NotImplementedError, match="attn_impl='plain'"):
        tr.fit(params, iter([batch]))


def test_kernel_wrappers_refuse_grad_inputs():
    """``refuse_grad``, which every CUDA wrapper calls before it launches:
    it raises when a caller could need the result's gradient."""
    from repro_torch.kernels import refuse_grad
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("flash_attention", torch.ones(2), x)
    with torch.no_grad():
        refuse_grad("flash_attention", x)
    refuse_grad("flash_attention", x.detach(), None)
