"""The port's MoE channel block (``models/moe.py``) against the JAX
package on the same inputs (a numpy seed) and bridged weights.

Three shapes: dbrx's reduced config (4 experts, top-2, d 256), kimi_k2's
384 experts top-8 at a narrow width (d_model 32, d_ff 16: 96 routed rows
over 384 experts, so most experts get no token) and decode's T = B (four
tokens through reduced dbrx). The router's expert ids must be EQUAL, its
probabilities, weights and aux loss within 1e-6; ``moe_apply`` (routed)
and ``moe_ref`` (dense) within 1e-5 of the reference's ``moe_ref``;
over a mesh ``moe_apply`` runs the expert-parallel form
(tests/test_torch_mesh.py holds it to the reference's). Last,
kimi's segment plan (a ``single`` dense layer, then a ``scan`` of MoE
layers stacked on a leading axis) crosses the bridge leaf for leaf and
its forward (logits and aux) matches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import MoEConfig, get_reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.backbone import scan_plan
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
CPU = torch.device("cpu")
# name: (arch, config overrides, token shape)
SHAPES = {
    "dbrx": ("dbrx_132b", {}, (2, 12)),
    "kimi384": ("kimi_k2_1t_a32b",
                dict(d_model=32, moe=MoEConfig(n_experts=384, top_k=8,
                                               d_ff=16)), (2, 6)),
    "decode": ("dbrx_132b", {}, (4, 1)),
}


@pytest.fixture(scope="module", params=list(SHAPES))
def case(request):
    """Port and reference configs, numpy expert params and the input."""
    arch, over, (b, s) = SHAPES[request.param]
    cfg = get_reduced(arch).replace(**over)
    jcfg = jax_get_reduced(arch).replace(**over)
    p = jax.tree.map(np.array, jmoe.moe_init(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(41)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return request.param, cfg, jcfg, p, x


def test_router_matches_reference(case):
    name, cfg, _, p, x = case
    xf = x.reshape(-1, x.shape[-1])
    jprobs, jw, jids, jaux = jmoe._router(jnp.asarray(xf),
                                          jnp.asarray(p["w_router"]),
                                          cfg.moe.top_k)
    probs, w, ids, aux = tmoe._router(torch.from_numpy(xf),
                                      torch.from_numpy(p["w_router"]),
                                      cfg.moe.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    if name == "kimi384":
        assert np.unique(ids.numpy()).size < cfg.moe.n_experts // 2


@pytest.mark.parametrize("fn", ["moe_apply", "moe_ref"])
def test_moe_matches_reference(case, fn):
    """Both of the port's forms against the reference's ``moe_ref``."""
    _, cfg, jcfg, p, x = case
    jy, jaux = jmoe.moe_ref(p, jnp.asarray(x), jcfg)
    y, aux = getattr(tmoe, fn)(tree_to_torch(p, CPU), torch.from_numpy(x),
                               cfg)
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


def test_moe_apply_is_deterministic_and_refuses_a_mesh(case, monkeypatch):
    """The routed form sums in a fixed order (no atomics): two runs are
    bit-equal. Over a mesh (``make_host_mesh(2, 1)`` on the CPU) it no
    longer refuses (the name is kept from when it raised): it runs the
    expert-parallel form, ``moe_apply_ep`` called with that mesh, and
    with a capacity factor at which nothing drops its y is the routed
    form's function."""
    _, cfg, _, p, x = case
    tp, tx = tree_to_torch(p, CPU), torch.from_numpy(x)
    assert torch.equal(tmoe.moe_apply(tp, tx, cfg)[0],
                       tmoe.moe_apply(tp, tx, cfg)[0])
    mesh = make_host_mesh(2, 1, device="cpu")
    calls = []
    real = tmoe.moe_apply_ep

    def ep(*a, **k):
        calls.append(a[3])
        return real(*a, **k)
    monkeypatch.setattr(tmoe, "moe_apply_ep", ep)
    wide = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=8.0))
    y, aux = tmoe.moe_apply(tp, tx, wide, mesh=mesh)
    assert calls == [mesh]
    np.testing.assert_allclose(y.numpy(),
                               tmoe.moe_apply(tp, tx, wide)[0].numpy(),
                               atol=ATOL)
    assert np.isfinite(float(aux))


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    return tuple(t.shape)


def test_kimi_plan_bridges_and_forward_matches():
    """kimi_k2 reduced at three layers: a ``single`` dense layer (its
    ``dense_d_ff`` MLP) then a ``scan`` of two MoE layers whose leaves
    stack on a leading axis of 2. The reference's tree crosses with the
    port's init shapes, and ``Model.forward`` matches: logits within
    1e-4, the summed router aux within 1e-6."""
    cfg = get_reduced("kimi_k2_1t_a32b").replace(n_layers=3)
    jcfg = jax_get_reduced("kimi_k2_1t_a32b").replace(n_layers=3)
    plan = scan_plan(cfg)
    assert [(s.kind, s.reps) for s in plan] == [("single", 1), ("scan", 2)]
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(8))
    tp = tree_to_torch(jp, CPU)
    assert _shapes(tp) == _shapes(build_model(cfg, device="cpu").init(0))
    dense = tp["layers"]["seg0"]["l0"]["chan"]
    assert dense["w_up"].shape == (cfg.d_model, cfg.dense_d_ff)
    experts = tp["layers"]["seg1"]["l0"]["chan"]
    assert experts["w_gate"].shape == (2, cfg.moe.n_experts, cfg.d_model,
                                       cfg.moe.d_ff)
    toks = np.random.default_rng(42).integers(0, cfg.vocab, (2, 12))
    jl, _, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _, aux = build_model(cfg, device="cpu").forward(
            tp, {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    assert float(aux) > 0
