"""The port's sharding rules (``repro_torch/sharding/rules.py``), the
spec helpers of ``launch/steps.py`` and every model's ``*_specs``
against the JAX package's, on device-free meshes
(``abstract_mesh(data=16, model=16)``, ``abstract_mesh(store=8)`` and
the reference's counterparts), so no subprocess is needed.

Specs compare as tuples (the reference's ``PartitionSpec`` iterates as
one), bit for bit: ``make_rules`` for every arch of the zoo at its full
config (the FSDP threshold, the uneven-heads fallback, overrides),
``_spec_for`` on hypothesis-drawn names, rules, shapes and mesh sizes,
``batch_shardings``, ``cache_shardings``, the memo-store rules,
``opt_spec_tree`` for AdamW and Adafactor legalized against each
optimizer's state, ``cache_shardings_for`` on every arch's decode
caches, and ``Model.specs()`` tree for tree, legalized against the
params (the port's on ``torch.device("meta")``, the reference's from
``jax.eval_shape``) with every sharded dim dividing its axes, as
``tests/test_sharding.py`` checks the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.launch.mesh import abstract_mesh as jabstract_mesh
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding import rules as jrules
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.sharding import rules
from repro_torch.tree import flat_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

META = torch.device("meta")


def _meshes(**axes):
    return abstract_mesh(**axes), jabstract_mesh(**axes)


def _specs_of(shardings):
    """Flat {key: spec tuple} of a tree of either package's shardings."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif t is not None:
            out[prefix] = tuple(t.spec)
    walk(shardings, "")
    return out


# ------------------------------------------------------------ make_rules

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_rules_equal_for_every_arch(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for axes in (dict(data=16, model=16), dict(data=4, model=2),
                 dict(pod=2, data=16, model=16), dict(data=8, model=6),
                 dict(store=8)):
        m, jm = _meshes(**axes)
        for kw in ({}, {"fsdp": True}, {"fsdp": False},
                   {"overrides": {"ff": ("data", "model"), "new": "pod"}}):
            assert rules.make_rules(cfg, m, **kw) == \
                jrules.make_rules(jcfg, jm, **kw), (arch, axes, kw)


def test_fsdp_threshold_and_uneven_heads():
    m, jm = _meshes(data=16, model=16)
    small, big = get_config("qwen2_1_5b"), get_config("chameleon_34b")
    assert rules.make_rules(small, m)["embed"] is None
    assert rules.make_rules(big, m)["embed"] == "data"
    assert jrules.make_rules(jget_config("chameleon_34b"), jm)["embed"] \
        == "data"
    assert rules.FSDP_THRESHOLD == jrules.FSDP_THRESHOLD
    # bert_base's 12 heads over model=16: fewer than 2 x 16, replicated
    assert rules.make_rules(get_config("bert_base"), m)["heads"] is None
    assert rules.make_rules(get_config("qwen3_8b"), m)["heads"] == "model"


# ------------------------------------------------------------- _spec_for

_AXES = st.sampled_from(["data", "model", "pod"])
_RULE = st.one_of(st.none(), _AXES, st.tuples(_AXES, _AXES),
                  st.tuples(_AXES), st.lists(_AXES, max_size=2),
                  st.just(()))
_NAMES = st.sampled_from(["a", "b", "c", "d", "e"])


@settings(max_examples=300, deadline=None)
@given(names=st.lists(st.one_of(st.none(), _NAMES), max_size=5),
       rule_map=st.dictionaries(_NAMES, _RULE, max_size=5),
       sizes=st.tuples(st.integers(1, 8), st.integers(1, 8),
                       st.integers(1, 3)),
       dims=st.lists(st.integers(1, 48), min_size=5, max_size=5),
       with_shape=st.booleans())
def test_spec_for_matches_reference(names, rule_map, sizes, dims,
                                    with_shape):
    m, jm = _meshes(pod=sizes[2], data=sizes[0], model=sizes[1])
    shape = tuple(dims[:len(names)]) if with_shape else None
    got = rules._spec_for(tuple(names), rule_map, m, shape)
    want = jrules._spec_for(tuple(names), rule_map, jm, shape)
    assert tuple(got) == tuple(want)
    assert isinstance(got, tuple) and isinstance(got, rules.P)


def test_spec_basic_cases():
    """The reference's own cases (tests/test_sharding.py)."""
    m, _ = _meshes(data=16, model=16)
    r = {"embed": None, "ff": "model", "experts": "data"}
    assert rules._spec_for(("embed", "ff"), r, m) == (None, "model")
    assert rules._spec_for(("experts", "embed", "ff"), r, m) == \
        ("data", None, "model")
    assert rules._spec_for(("a", "b"), {"a": "model", "b": "model"}, m) \
        == ("model",)
    v = {"vocab": "model", "embed": None}
    assert rules._spec_for(("vocab", "embed"), v, m,
                           shape=(73448, 2560)) == ()
    assert rules._spec_for(("vocab", "embed"), v, m,
                           shape=(73728, 2560)) == ("model",)


# -------------------------------------------- batch / cache / memo rules

def _shape_tree(shapes):
    port = {k: torch.empty(s, device=META) for k, s in shapes.items()}
    ref = {k: jax.ShapeDtypeStruct(s, jnp.float32)
           for k, s in shapes.items()}
    return port, ref


@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")])
def test_batch_and_cache_shardings_match_reference(dp_axes):
    shapes = {"tokens": (32, 128), "odd": (3, 8), "one": (1, 4096, 8, 64),
              "long": (1, 4000, 8, 64), "scalar": (), "vec": (64,),
              "big": (64, 512, 4, 16), "short": (32, 8, 2)}
    port, ref = _shape_tree(shapes)
    for axes in (dict(data=16, model=16), dict(pod=2, data=4, model=2),
                 dict(data=4, model=2), dict(pod=3, data=2, model=8)):
        if not set(dp_axes) <= set(axes):
            continue            # the reference refuses a spec off its mesh
        m, jm = _meshes(**axes)
        assert _specs_of(rules.batch_shardings(port, m, dp_axes)) == \
            _specs_of(jrules.batch_shardings(ref, jm, dp_axes))
        got = rules.cache_shardings(port, m, dp_axes)
        want = jrules.cache_shardings(ref, jm, dp_axes)
        assert _specs_of(got) == _specs_of(want), axes


def test_memo_store_rules_match_reference():
    m, jm = _meshes(store=8)
    assert rules.memo_store_rules("tier") == jrules.memo_store_rules("tier")
    for ndim, shape in ((3, (64, 4, 4)), (1, (64,)), (2, (60, 4)),
                        (2, None), (4, (8, 2, 3, 5))):
        assert tuple(rules.memo_row_spec(m, ndim, shape=shape)) == \
            tuple(jrules.memo_row_spec(jm, ndim, shape=shape))
    port, ref = _shape_tree({"table": (64, 16), "slot_at": (64,),
                             "odd": (60, 4), "arena": (64, 2, 8, 8)})
    assert _specs_of(rules.memo_store_shardings(m, port)) == \
        _specs_of(jrules.memo_store_shardings(jm, ref))


# --------------------------------------------------- model specs, steps

@pytest.fixture(scope="module")
def zoo():
    """arch → (port model, reference model, port meta params, reference
    abstract params)."""
    out = {}
    for arch in ARCH_IDS:
        m, jm = build_model(get_config(arch), device=META), \
            jbuild_model(jget_config(arch))
        jabs = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        out[arch] = (m, jm, steps.abstract_params(m), jabs)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_specs_equal_reference_and_mirror_params(zoo, arch):
    """``Model.specs()`` equals the reference's tree for tree; it has the
    params tree's keys, each tuple as long as its leaf's rank; the meta
    params have the reference's shapes."""
    m, jm, abs_p, jabs = zoo[arch]
    specs = m.specs()
    assert specs == jm.specs()
    flat_s, flat_p = flat_params(specs), flat_params(abs_p)
    assert set(flat_s) == set(flat_p)
    jflat = flat_params(jabs)
    for k, p in flat_p.items():
        assert p.device == META
        assert len(flat_s[k]) == p.ndim, (k, flat_s[k], p.shape)
        assert tuple(p.shape) == tuple(jflat[k].shape), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_to_shardings_legal_and_equal(zoo, arch):
    """Legalized against the params, every sharded dim divides its axes,
    and each spec equals the reference's; also unlegalized, and for the
    optimizer state of AdamW and Adafactor (``opt_spec_tree``)."""
    m, jm, abs_p, jabs = zoo[arch]
    mesh, jmesh = _meshes(data=16, model=16)
    cfg = get_config(arch)
    r = rules.make_rules(cfg, mesh)
    got = rules.logical_to_shardings(m.specs(), r, mesh, abs_p)
    want = jrules.logical_to_shardings(jm.specs(), r, jmesh, jabs)
    assert _specs_of(got) == _specs_of(want)
    flat_p = flat_params(abs_p)
    for k, spec in _specs_of(got).items():
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = int(np.prod([mesh.shape[a] for a in axes]))
            assert flat_p[k].shape[i] % size == 0, (arch, k, spec)
    assert _specs_of(rules.logical_to_shardings(m.specs(), r, mesh)) == \
        _specs_of(jrules.logical_to_shardings(jm.specs(), r, jmesh))
    for opt in ("adamw", "adafactor"):
        ospecs = steps.opt_spec_tree(opt, m.specs())
        assert ospecs == jsteps.opt_spec_tree(opt, jm.specs())
        o_abs = make_optimizer(opt)[0](abs_p)
        jo_abs = jax.eval_shape(jmake_optimizer(opt)[0], jabs)
        assert _specs_of(rules.logical_to_shardings(
            ospecs, r, mesh, o_abs)) == _specs_of(jrules.logical_to_shardings(
                ospecs, r, jmesh, jo_abs)), (arch, opt)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_for_every_arch(zoo, arch):
    """``cache_shardings_for`` on the arch's decode caches (the port's
    ``init_caches`` on the meta device against the reference's
    ``jax.eval_shape``), B = 1 long-context, a batch over dp and a
    batch that does not divide."""
    m, jm, _, _ = zoo[arch]
    for axes, dp in ((dict(data=16, model=16), ("data",)),
                     (dict(pod=2, data=16, model=16), ("pod", "data")),
                     (dict(data=4, model=2), ("data",))):
        mesh, jmesh = _meshes(**axes)
        for b, s, window in ((1, 4096, None), (32, 2048, None),
                             (3, 100, None), (16, 1024, 256)):
            caches = m.init_caches(b, s, window=window)
            jcaches = jax.eval_shape(
                lambda: jm.init_caches(b, s, window=window))
            got = steps.cache_shardings_for(caches, mesh, dp)
            want = jsteps.cache_shardings_for(jcaches, jmesh, dp)
            assert _specs_of(got) == _specs_of(want), (arch, axes, b, s)
