"""The port's model mesh against the JAX package's: ``launch/mesh.py``,
the expert-parallel MoE (``models/moe.py``'s ``moe_apply_ep``) and
``Model(mesh=...)``.

The reference's mesh needs 8 devices, and JAX locks its device count at
its first init, so one module fixture runs the reference in a subprocess
with ``--xla_force_host_platform_device_count=8`` on
``make_host_mesh(4, 2)``: it reads the inputs and weights this module
made (an ``.npz``) and writes its outputs back. The port runs the same
(4, 2) mesh on ``make_host_mesh(4, 2, device="cpu")``, all eight slots
on the CPU. Held to the reference:

* ``_bucketize`` bit for bit on random keys (in process: it needs no
  mesh);
* ``moe_apply_ep`` at reduced dbrx on both bodies (the chunked one at
  T = 64 over 4 token shards, the small-token one at T = 4), at
  ``capacity_factor`` 8.0 (nothing drops) and 1.0 (rows drop): y within
  ATOL (the measured gap is printed with ``-s``), aux within 1e-6, and
  the grads of a scalar loss within ATOL of each leaf's max(1, max|g|);
  the exchanges counted through
  ``moe._ALL_TO_ALL``, 4 a dispatch chunk;
* ``Model(mesh=...)`` at reduced dbrx (2 layers, the config's capacity
  factor 1.25, so rows drop) on the same bridged params: ``forward``
  logits, ``prefill`` logits and caches, 4 ``decode_step``s (the small
  body) and ``train_loss`` with its grads, within MODEL_TOL (grads:
  of each leaf's max(1, max|g|));
* one ``Trainer`` step over the mesh with ``donate=False`` (the caller's
  trees are bit-unchanged) and ``donate=True`` (the same values, in the
  caller's tensors).
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import (ModelMesh, abstract_mesh, dp_axes_of,
                                     make_host_mesh)
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import flat_params, nest_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ATOL = 1e-5          # moe_apply_ep y and grads against the reference's
MODEL_TOL = 1e-4     # logits and caches, the zoo tests' tolerance
FACTORS = (8.0, 1.0)
# body: token shape (chunked: T = 64 = 16 a token shard, 2 chunks of 8;
# small: T = 4 < 4 x 4 token shards)
BODIES = {"chunked": (4, 16), "small": (4, 1)}
B, S, CACHE, DECODE = 4, 16, 24, 4

_REF_CODE = r"""
import contextlib, dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.launch.mesh import make_host_mesh
from repro.models import build_model, moe as moe_mod

inp = dict(np.load(sys.argv[1]))


def nest(prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return out


def flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}", out)
    elif tree is not None:
        out[prefix] = np.asarray(tree)


mesh = make_host_mesh(4, 2)
assert len(jax.devices()) == 8
base = get_reduced("dbrx_132b")
out = {}
set_mesh = getattr(jax, "set_mesh", None)
with (set_mesh(mesh) if set_mesh else contextlib.nullcontext()):
    moe_p = nest("moe/")
    for cf in (8.0, 1.0):
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   capacity_factor=cf))
        for body in ("chunked", "small"):
            x, r = jnp.asarray(inp[f"x_{body}"]), jnp.asarray(inp[f"r_{body}"])

            def loss(p, xx):
                y, aux = moe_mod.moe_apply_ep(p, xx, cfg, mesh)
                return jnp.sum(y * r) + aux, (y, aux)
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(moe_p, x)
            tag = f"ep/{body}/{cf}"
            out[f"{tag}/y"], out[f"{tag}/aux"] = np.asarray(y), np.asarray(aux)
            flat(gp, f"{tag}/grad", out)
            out[f"{tag}/grad/x"] = np.asarray(gx)

    model = build_model(base, mesh=mesh)
    params = nest("model/")
    tokens = jnp.asarray(inp["tokens"])
    batch = {"tokens": tokens}
    logits, _, aux = jax.jit(model.forward)(params, batch)
    out["forward/logits"], out["forward/aux"] = (np.asarray(logits),
                                                 np.asarray(aux))
    lg, caches = jax.jit(lambda p, b: model.prefill(
        p, b, cache_len=int(inp["cache_len"])))(params, batch)
    out["prefill/logits"] = np.asarray(lg)
    flat(caches, "prefill/caches", out)
    step = jax.jit(model.decode_step)
    dec = inp["decode_tokens"]
    for i in range(dec.shape[1]):
        lg, caches = step(params, jnp.asarray(dec[:, i:i + 1]), caches,
                          jnp.asarray(tokens.shape[1] + i, jnp.int32))
        out[f"decode/{i}/logits"] = np.asarray(lg)
    flat(caches, "decode/caches", out)
    loss, grads = jax.jit(jax.value_and_grad(model.train_loss))(params,
                                                                batch)
    out["train/loss"] = np.asarray(loss)
    flat(grads, "train/grad", out)
np.savez(sys.argv[2], **out)
print("REF-MESH-DONE")
"""


def _cfg(cf=None):
    cfg = get_reduced("dbrx_132b")
    if cf is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _moe_params(cfg, rng):
    d, m = cfg.d_model, cfg.moe
    return {"w_router": rng.standard_normal((d, m.n_experts)) * d ** -0.5,
            "w_gate": rng.standard_normal((m.n_experts, d, m.d_ff))
            * d ** -0.5,
            "w_up": rng.standard_normal((m.n_experts, d, m.d_ff)) * d ** -0.5,
            "w_down": rng.standard_normal((m.n_experts, m.d_ff, d))
            * m.d_ff ** -0.5}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Inputs, port params and the reference's outputs on (4, 2)."""
    cfg = _cfg()
    rng = np.random.default_rng(27)
    moe_p = {k: v.astype(np.float32)
             for k, v in _moe_params(cfg, rng).items()}
    inp = {f"moe/{k}": v for k, v in moe_p.items()}
    for body, shp in BODIES.items():
        inp[f"x_{body}"] = rng.standard_normal(
            shp + (cfg.d_model,)).astype(np.float32)
        inp[f"r_{body}"] = rng.standard_normal(
            shp + (cfg.d_model,)).astype(np.float32)
    params = build_model(cfg, device=CPU).init(5)
    for k, v in flat_params(params).items():
        inp[f"model/{k}"] = v.numpy()
    inp["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    inp["decode_tokens"] = rng.integers(0, cfg.vocab,
                                        (B, DECODE)).astype(np.int32)
    inp["cache_len"] = np.asarray(CACHE)
    d = tmp_path_factory.mktemp("ref_mesh")
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", _REF_CODE, str(d / "in.npz"),
                          str(d / "out.npz")], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    assert "REF-MESH-DONE" in res.stdout, res.stderr[-3000:]
    return inp, params, dict(np.load(d / "out.npz"))


def _mesh():
    return make_host_mesh(4, 2, device="cpu")


def _sub(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _close_tree(got, want, atol, what, relative=False):
    """Every leaf of ``want`` (flat keys) against ``got`` within ``atol``
    (with ``relative``: ``atol`` times max(1, max|want|) of the leaf, for
    grads, whose scale is the loss's); returns the largest gap (relative
    to that scale)."""
    gap = 0.0
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        scale = max(1.0, float(np.abs(w).max())) if relative else 1.0
        gap = max(gap, float(np.abs(g - w).max()) / scale)
        np.testing.assert_allclose(g, w, atol=atol * scale, rtol=0,
                                   err_msg=f"{what} {k}")
    return gap


# ---------------------------------------------------------------- mesh

def test_model_mesh_shape_devices_and_abstract():
    m = make_host_mesh(4, 2, device="cpu")
    assert m.axis_names == ("data", "model")
    assert list(m.shape.items()) == [("data", 4), ("model", 2)]
    assert m.shape.get("model", 1) == 2 and m.shape.get("pod", 1) == 1
    assert m.devices.shape == (4, 2) and m.lead == CPU
    assert m.device(data=3, model=1) == CPU
    assert dp_axes_of(m) == ("data",)
    a = abstract_mesh(pod=2, data=16, model=16)
    assert dp_axes_of(a) == ("pod", "data") and a.abstract
    assert a.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="abstract"):
        a.devices
    with pytest.raises(RuntimeError, match="abstract"):
        build_model(_cfg(), mesh=abstract_mesh(data=2))
    with pytest.raises(ValueError):
        ModelMesh((2, 2), ("data", "model"), [CPU] * 3)


def test_make_host_mesh_on_the_card_raises_without_one(monkeypatch):
    """No fallback: a CUDA mesh without a card raises, as ``device=None``
    does, instead of building a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh(2, 1, device=dev)


# --------------------------------------------------------- _bucketize

@pytest.mark.parametrize("n,buckets,cap", [(64, 4, 5), (97, 9, 3),
                                           (40, 2, 40), (1, 1, 1)])
def test_bucketize_bit_equal(n, buckets, cap):
    keys = np.random.default_rng(n).integers(0, buckets, n)
    got = tmoe._bucketize(torch.from_numpy(keys), buckets, cap)
    want = jmoe._bucketize(jnp.asarray(keys, jnp.int32), buckets, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ moe_apply_ep

@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("body", list(BODIES))
def test_moe_apply_ep_matches_reference(ref, monkeypatch, body, cf):
    """y and aux against the reference's EP; the grads of sum(y·r) + aux
    with respect to the four expert leaves and x. At 1.0 the chunked body
    drops rows (shown: it is off ``moe_ref``), at 8.0 nothing drops and
    it is ``moe_ref``'s function."""
    inp, _, out = ref
    cfg = _cfg(cf)
    tag = f"ep/{body}/{cf}"
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in _sub(inp, "moe/").items()}
    x = torch.from_numpy(inp[f"x_{body}"]).requires_grad_(True)
    r = torch.from_numpy(inp[f"r_{body}"])
    calls = []
    real = tmoe._ALL_TO_ALL

    def counting(bufs, devices):
        calls.append(len(bufs))
        return real(bufs, devices)

    monkeypatch.setattr(tmoe, "_ALL_TO_ALL", counting)
    y, aux = tmoe.moe_apply(p, x, cfg, mesh=_mesh())
    loss = torch.sum(y * r) + aux
    grads = torch.autograd.grad(loss, list(p.values()) + [x])
    gap = _close_tree({"y": y.detach().numpy()}, {"y": out[f"{tag}/y"]},
                      ATOL, tag)
    np.testing.assert_allclose(float(aux.detach()),
                               float(out[f"{tag}/aux"]), atol=1e-6)
    got_g = dict(zip(list(p) + ["x"], (g.numpy() for g in grads)))
    ggap = _close_tree(got_g, _sub(out, f"{tag}/grad/"), ATOL, tag,
                       relative=True)
    print(f"[mesh] moe_apply_ep {body} cf={cf}: max|dy| {gap:.2e}, "
          f"max|dgrad| / max(1, max|grad|) {ggap:.2e} against the "
          f"reference's EP")
    y_ref = tmoe.moe_ref(p, x, cfg)[0].detach()
    dropped = not torch.allclose(y.detach(), y_ref, atol=ATOL)
    if body == "chunked":
        # 2 chunks x 4 exchanges, one group
        assert calls == [4] * 8
        assert dropped == (cf == 1.0)
    else:
        assert calls == [] and not dropped


@pytest.mark.parametrize("T", [64, 2])
def test_moe_apply_ep_over_pods(monkeypatch, T):
    """A (pod, data, model) mesh with ``dp_axes=("pod", "data")`` (the
    reference's ``dp_axes_of`` of a multi-pod mesh): tokens split over
    both axes, experts over ``data`` alone, so each pod is its own
    exchange group (4 exchanges a chunk a pod). With nothing dropped it
    is the routed form's function, on both bodies."""
    cfg = _cfg(8.0)
    rng = np.random.default_rng(T)
    p = {k: torch.from_numpy(v.astype(np.float32))
         for k, v in _moe_params(cfg, rng).items()}
    x = torch.from_numpy(rng.standard_normal(
        (T, cfg.d_model)).astype(np.float32))
    mesh = ModelMesh((2, 2, 2), ("pod", "data", "model"), [CPU] * 8)
    calls = []
    real = tmoe._ALL_TO_ALL

    def counting(bufs, devices):
        calls.append(len(bufs))
        return real(bufs, devices)

    monkeypatch.setattr(tmoe, "_ALL_TO_ALL", counting)
    y, aux = tmoe.moe_apply(p, x, cfg, mesh=mesh, dp_axes=dp_axes_of(mesh))
    np.testing.assert_allclose(y.numpy(), tmoe.moe_apply(p, x, cfg)[0].numpy(),
                               atol=ATOL)
    # chunked: 16 tokens a shard in 2 chunks, 2 pods; small: none
    assert calls == ([2] * 16 if T == 64 else [])
    with pytest.raises(ValueError, match="token axes"):
        tmoe.moe_apply(p, x, cfg, mesh=mesh)          # pod not in dp_axes


def test_moe_apply_ep_reads_nothing_back(monkeypatch):
    """Every buffer size comes from static shapes: no ``.item()``,
    ``.tolist()`` or ``.cpu()`` on the way (the routed form reads its
    expert offsets once)."""
    cfg = _cfg(1.25)
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v.astype(np.float32))
         for k, v in _moe_params(cfg, rng).items()}
    x = torch.from_numpy(rng.standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    reads = []
    for name in ("item", "tolist", "cpu"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    tmoe.moe_apply(p, x, cfg, mesh=_mesh())
    tmoe.moe_apply(p, x[:, :1], cfg, mesh=_mesh())
    assert reads == []
    tmoe.moe_apply(p, x, cfg)
    assert reads == ["cpu", "tolist"]


# ------------------------------------------------------ Model(mesh=...)

@pytest.fixture(scope="module")
def port(ref):
    inp, params, _ = ref
    model = build_model(_cfg(), mesh=_mesh())
    assert model.device == CPU and model.mesh.shape["data"] == 4
    return model, params, {"tokens": torch.from_numpy(inp["tokens"])}


def test_model_mesh_forward_matches_reference(ref, port):
    _, _, out = ref
    model, params, batch = port
    with torch.no_grad():
        logits, _, aux = model.forward(params, batch)
    gap = _close_tree({"l": logits.numpy()}, {"l": out["forward/logits"]},
                      MODEL_TOL, "forward")
    np.testing.assert_allclose(float(aux), float(out["forward/aux"]),
                               atol=1e-6)
    with torch.no_grad():
        routed = build_model(_cfg(), device=CPU).forward(params, batch)[0]
    moved = float((routed - logits).abs().max())
    print(f"[mesh] Model(mesh) forward: max|dlogits| {gap:.2e}; the "
          f"capacity drops move it {moved:.3f} off the routed forward")
    assert moved > 100 * MODEL_TOL


def test_model_mesh_prefill_and_decode_match_reference(ref, port):
    inp, _, out = ref
    model, params, batch = port
    with torch.no_grad():
        lg, caches = model.prefill(params, batch, cache_len=CACHE)
        _close_tree({"l": lg.numpy()}, {"l": out["prefill/logits"]},
                    MODEL_TOL, "prefill")
        _close_tree({k: v.numpy() for k, v in flat_params(caches).items()},
                    _sub(out, "prefill/caches/"), MODEL_TOL,
                    "prefill caches")
        dec = inp["decode_tokens"]
        gaps = []
        for i in range(dec.shape[1]):
            lg, caches = model.decode_step(params, dec[:, i:i + 1], caches,
                                           S + i)
            gaps.append(_close_tree({"l": lg.numpy()},
                                    {"l": out[f"decode/{i}/logits"]},
                                    MODEL_TOL, f"decode {i}"))
        _close_tree({k: v.numpy() for k, v in flat_params(caches).items()},
                    _sub(out, "decode/caches/"), MODEL_TOL, "decode caches")
    print(f"[mesh] Model(mesh) decode: max|dlogits| a step {gaps}")


def test_model_mesh_train_loss_grads_match_reference(ref, port):
    _, _, out = ref
    model, params, batch = port
    loss, grads = value_and_grad(model.train_loss, params, batch)
    np.testing.assert_allclose(float(loss), float(out["train/loss"]),
                               atol=MODEL_TOL)
    gap = _close_tree({k: v.numpy() for k, v in flat_params(grads).items()},
                      _sub(out, "train/grad/"), MODEL_TOL, "train grads",
                      relative=True)
    print(f"[mesh] Model(mesh) train_loss {float(loss):.6f}, max|dgrad| "
          f"{gap:.2e}")


def _clone(tree):
    return nest_params({k: v.clone() for k, v in flat_params(tree).items()})


def test_trainer_step_over_the_mesh_donates_or_not(port):
    """``donate=False`` leaves the caller's params and optimizer state
    bit-unchanged; ``donate=True`` gives the caller's own tensors the same
    values ``donate=False`` returns."""
    model, params, batch = port
    tcfg = TrainConfig(steps=4, optimizer="adafactor")
    kept = Trainer(model, tcfg, donate=False)
    p0 = _clone(params)
    o0 = kept.init_opt(p0)
    before = {k: v.clone() for k, v in flat_params(p0).items()}
    p1, o1, l1 = kept.step(p0, o0, batch, 1)
    assert o0["t"] == 0 and o1["t"] == 1
    for k, v in flat_params(p0).items():
        assert torch.equal(v, before[k]), k
    assert all(float(v.abs().max()) == 0
               for v in flat_params(o0["s"]).values())
    p2 = _clone(params)
    o2 = kept.init_opt(p2)
    tensors = {k: id(v) for k, v in flat_params(p2).items()}
    donated = Trainer(model, tcfg)
    assert donated.donate
    p3, o3, l3 = donated.step(p2, o2, batch, 1)
    assert p3 is p2 and o3 is o2 and o2["t"] == 1
    assert torch.equal(l1, l3)
    for k, v in flat_params(p2).items():
        assert id(v) == tensors[k]
        assert torch.equal(v, flat_params(p1)[k]), k
    for k, v in flat_params(o2["s"]).items():
        assert torch.equal(v, flat_params(o1["s"])[k]), k
