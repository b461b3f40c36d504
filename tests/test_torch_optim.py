"""The port's optimizers and LR schedules against the JAX package's.

Tolerances: three optimizer steps fed the same numpy grads agree within
1e-6 relative (per leaf, max|Δ| ≤ 1e-6·max|ref|): the same f32
arithmetic, summed in another order. The schedules agree within 1e-6 of
``peak``: near the end of the decay 1 + cos(π·prog) cancels, so one ulp
between the two libraries' f32 ``cos`` is a large share of a value near
``floor``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.bridge import tree_to_torch
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, cosine_schedule, linear_warmup,
                               make_optimizer)
from repro_torch.tree import flat_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-6
CPU = torch.device("cpu")
OPTS = {"adamw": ((adamw_init, adamw_update),
                  (jadamw.adamw_init, jadamw.adamw_update)),
        "adafactor": ((adafactor_init, adafactor_update),
                      (jadafactor.adafactor_init,
                       jadafactor.adafactor_update))}


def _close(port, ref, rtol=RTOL):
    """Every leaf of the ``port`` tree within ``rtol``·max|ref leaf| of
    the ``ref`` tree's."""
    got, ref = flat_params(port), flat_params(ref)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        gap = float(np.max(np.abs(np.asarray(got[k]) - r)))
        assert gap <= rtol * float(np.max(np.abs(r))), (k, gap)


def _tree(rng):
    """A 1-D leaf, a 2-D one, a stacked (reps, rows, cols) scan leaf and
    a (reps, E, d, ff) expert leaf, nested as the model's trees are."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"b": a(16), "w": a(8, 16),
            "layers": {"seg0": {"l0": {"wq": a(3, 8, 16),
                                       "experts": a(2, 4, 8, 12)}}}}


@pytest.mark.parametrize("warmup,total,peak,floor",
                         [(20, 100, 3e-4, 0.0), (5, 30, 1e-3, 1e-5),
                          (0, 12, 1.0, 0.0), (10, 10, 0.5, 0.0)])
def test_schedules_match_reference(warmup, total, peak, floor):
    for s in range(total + 3):
        ref = float(jschedule.cosine_schedule(s, warmup, total, peak, floor))
        got = cosine_schedule(s, warmup, total, peak, floor)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert abs(float(got) - ref) <= RTOL * peak, (s, float(got), ref)
        ref = float(jschedule.linear_warmup(s, warmup, peak))
        got = linear_warmup(s, warmup, peak)
        assert abs(float(got) - ref) <= RTOL * peak, (s, float(got), ref)
    # a tensor step stays a tensor computation
    t = cosine_schedule(torch.tensor(3), warmup, total, peak, floor)
    assert float(t) == pytest.approx(float(cosine_schedule(
        3, warmup, total, peak, floor)))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name):
    """Three steps from the same params and numpy grads, with grad_clip
    (adafactor takes and ignores it, as the reference does) and weight
    decay: params and state within 1e-6 relative, ``t`` equal."""
    (init, update), (jinit, jupdate) = OPTS[name]
    rng = np.random.default_rng(3)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    tp = tree_to_torch(jp, CPU)
    js, ts = jinit(jp), init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: x * (1.0 + 10.0 * step),
                         _tree(np.random.default_rng(10 + step)))
        kw = dict(lr=1e-2 / (step + 1), weight_decay=0.1, grad_clip=0.5)
        jp, js = jupdate(jp, jax.tree.map(jnp.asarray, g), js, **kw)
        tp, ts = update(tp, tree_to_torch(g, CPU), ts, **kw)
        assert ts["t"] == int(js["t"]) == step + 1
        _close(tp, jp)
        _close({k: v for k, v in ts.items() if k != "t"},
               {k: v for k, v in js.items() if k != "t"})


def test_adafactor_factors_stacked_leaves_and_clips_whole_leaf():
    """A stacked leaf keeps its leading axes in ``vr``/``vc``; the RMS
    clip is over the whole stacked leaf, as the reference's: a spike in
    one layer's (one expert's) grads inflates its update's RMS, and so
    shrinks the other layers' steps, which a clip per layer would not."""
    rng = np.random.default_rng(5)
    p = {"wq": rng.standard_normal((3, 8, 16)).astype(np.float32),
         "experts": rng.standard_normal((2, 4, 8, 12)).astype(np.float32)}
    st = adafactor_init(tree_to_torch(p, CPU))
    assert st["s"]["wq"]["vr"].shape == (3, 8)
    assert st["s"]["wq"]["vc"].shape == (3, 16)
    assert st["s"]["experts"]["vr"].shape == (2, 4, 8)
    assert st["s"]["experts"]["vc"].shape == (2, 4, 12)
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    g["wq"][0, 0, 0] = 1e4
    g["experts"][1, 2, 0, 0] = 1e4
    tp, _ = adafactor_update(tree_to_torch(p, CPU), tree_to_torch(g, CPU),
                             st, lr=0.1)
    jp, _ = jadafactor.adafactor_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        jadafactor.adafactor_init(jax.tree.map(jnp.asarray, p)), lr=0.1)
    _close(tp, jp)
    # the same update taken one layer at a time clips each layer alone
    layer = {"wq": p["wq"][1:2], "experts": p["experts"][0:1]}
    glayer = {"wq": g["wq"][1:2], "experts": g["experts"][0:1]}
    lp, _ = adafactor_update(tree_to_torch(layer, CPU),
                             tree_to_torch(glayer, CPU),
                             adafactor_init(tree_to_torch(layer, CPU)),
                             lr=0.1)
    for k, sl in (("wq", slice(1, 2)), ("experts", slice(0, 1))):
        step_whole = tp[k][sl] - torch.from_numpy(p[k][sl])
        step_alone = lp[k] - torch.from_numpy(layer[k])
        assert step_whole.abs().max() < 0.5 * step_alone.abs().max(), k


def test_make_optimizer_names():
    assert make_optimizer("adamw") == (adamw_init, adamw_update)
    assert make_optimizer("adafactor") == (adafactor_init, adafactor_update)
    with pytest.raises(ValueError, match="sgd"):
        make_optimizer("sgd")


# ------------------------------------------- ports of test_substrate.py

def _quad_params(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nest": {"b": torch.randn((8,), generator=g)}}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_reduce_quadratic(opt):
    from repro_torch.train.trainer import value_and_grad
    params = _quad_params(0)
    init, update = make_optimizer(opt)
    state = init(params)

    def loss_fn(p, _batch):
        return torch.sum((p["a"] - 1.0) ** 2) + torch.sum(
            (p["nest"]["b"] - 1.0) ** 2)
    l0 = float(loss_fn(params, None))
    for _ in range(200):
        _, g = value_and_grad(loss_fn, params, None)
        params, state = update(params, g, state, lr=3e-2)
    assert float(loss_fn(params, None)) < l0 * 0.05


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((64, 128)), "b": torch.zeros((128,))}
    st = adafactor_init(params)
    assert st["s"]["w"]["vr"].shape == (64,)
    assert st["s"]["w"]["vc"].shape == (128,)
    assert st["s"]["b"]["v"].shape == (128,)
    adam = adamw_init(params)
    fac_bytes = sum(x.numel() * 4 for x in (
        st["s"]["w"]["vr"], st["s"]["w"]["vc"], st["s"]["b"]["v"]))
    adam_bytes = sum(x.numel() * 4 for x in adam["m"].values()) * 2
    assert fac_bytes < adam_bytes / 20


def test_grad_clip():
    params = {"w": torch.ones((4,))}
    g = {"w": torch.full((4,), 1e6)}
    p2, _ = adamw_update(params, g, adamw_init(params), lr=1.0,
                         grad_clip=1.0)
    assert torch.isfinite(p2["w"]).all()
    # the clipped step of AdamW's first update is lr in every coordinate
    np.testing.assert_allclose(p2["w"].numpy(), 0.0, atol=1e-5)
    assert float(params["w"][0]) == 1.0          # inputs left untouched


def test_cosine_schedule_shape():
    assert float(cosine_schedule(0, 10, 100, 1.0)) < 0.2
    assert float(cosine_schedule(10, 10, 100, 1.0)) == pytest.approx(
        1.0, abs=0.1)
    assert float(cosine_schedule(100, 10, 100, 1.0)) < 0.01
