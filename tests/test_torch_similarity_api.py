"""The reference names the port adds last: Eq. 2 (``memo_rate``), the
batch similarity matrix (``pairwise_similarity``), the ``repro.core``
package surface, the deprecated ``MemoConfig`` shim and
``rwkv6_3b.optimized()``, each held to the JAX package's.

``pairwise_similarity`` runs on softmax rows made with numpy from a seed
and must equal the reference's within ``SIM_TOL``: both take a head
average of 8-term L1 sums in f32, in another order. The shim's three
tests are the reference's ``tests/test_api.py`` shim tests run against
the port's classes."""
import dataclasses
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as port_core
import repro_torch.memo.specs as specs_mod
from repro_torch.core import similarity as port_sim
from repro_torch.memo import MemoConfig, MemoSpec, RuntimeSpec
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIM_TOL = 1e-6
N, M, H, L = 5, 3, 2, 8


def _softmax_rows(rng, n):
    x = rng.standard_normal((n, H, L, L)).astype(np.float32) * 2.0
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_similarity_matches_reference(seed):
    from repro.core.similarity import pairwise_similarity as ref
    rng = np.random.default_rng(seed)
    a, b = _softmax_rows(rng, N), _softmax_rows(rng, M)
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(b)))
    got = port_sim.pairwise_similarity(torch.from_numpy(a),
                                       torch.from_numpy(b))
    assert got.shape == (N, M) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SIM_TOL)
    # the diagonal of a batch against itself is 1; each entry is the
    # pair's similarity_score
    self_sim = port_sim.pairwise_similarity(torch.from_numpy(a),
                                            torch.from_numpy(a))
    np.testing.assert_allclose(torch.diagonal(self_sim).numpy(), 1.0,
                               rtol=0, atol=SIM_TOL)
    pairs = port_sim.similarity_score(torch.from_numpy(a[:M]),
                                      torch.from_numpy(b))
    np.testing.assert_allclose(torch.diagonal(got[:M]).numpy(),
                               pairs.numpy(), rtol=0, atol=SIM_TOL)


def test_pairwise_similarity_chunks_rows(monkeypatch):
    """With a chunk bound below one (M, H, L, L) block the rows go one at
    a time, and the chunking changes no value."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_softmax_rows(rng, N))
    b = torch.from_numpy(_softmax_rows(rng, M))
    whole = port_sim.pairwise_similarity(a, b)
    seen = []
    real_abs = torch.abs

    def spy(x):
        seen.append(tuple(x.shape))
        return real_abs(x)
    for bound in (1, 2 * M * H * L * L):
        seen.clear()
        monkeypatch.setattr(port_sim, "PAIR_CHUNK_ELEMS", bound)
        monkeypatch.setattr(port_sim.torch, "abs", spy)
        got = port_sim.pairwise_similarity(a, b)
        monkeypatch.setattr(port_sim.torch, "abs", real_abs)
        rows = max(1, bound // (M * H * L * L))
        assert seen == [(min(rows, N - i), M, H, L, L)
                        for i in range(0, N, rows)]
        assert torch.equal(got, whole)
    empty = port_sim.pairwise_similarity(a[:0], b)
    assert empty.shape == (0, M)


@pytest.mark.parametrize("args", [(0, 4, 12), (30, 4, 12), (7, 3, 5),
                                  (48, 4, 12)])
def test_memo_rate_matches_reference(args):
    from repro.core.similarity import memo_rate as ref
    assert port_sim.memo_rate(*args) == ref(*args)
    assert port_core.memo_rate is port_sim.memo_rate


def test_core_exports_every_reference_name():
    import repro.core as ref_core
    want = sorted(n for n in vars(ref_core) if not n.startswith("_")
                  and not isinstance(getattr(ref_core, n),
                                     type(ref_core)))
    assert len(want) == 30, want
    assert sorted(port_core.__all__) == want
    for name in want:
        value, ref_value = getattr(port_core, name), getattr(ref_core, name)
        assert isinstance(value, type) == isinstance(ref_value, type), name
        assert callable(value) == callable(ref_value), name
        if isinstance(ref_value, dict):
            assert sorted(value) == sorted(ref_value), name
    assert set(want) <= set(dir(port_core))
    with pytest.raises(AttributeError, match="no attribute"):
        port_core.no_such_name   # noqa: B018


def test_core_import_is_light_and_jax_free():
    """``import repro_torch.core`` loads no submodule; resolving every
    name loads the serving stack and still neither JAX nor the reference."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import sys\n"
        "import repro_torch.core as c\n"
        "assert 'repro_torch.core.engine' not in sys.modules\n"
        "assert 'torch' not in sys.modules, 'torch'\n"
        "for n in c.__all__: getattr(c, n)\n"
        "assert 'repro_torch.core.engine' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ------------------------------------------------------ MemoConfig shim
# the reference's tests/test_api.py shim tests, run on the port's classes

def test_flat_shim_maps_identically_and_warns_exactly_once():
    specs_mod._reset_flat_config_warning()
    kwargs = dict(threshold=0.8, mode="bucket", embed_steps=40,
                  admit=True, budget_mb=64.0, apm_codec="f16",
                  index_kind="ivf", nprobe=8, device_slack=2.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = MemoConfig(**kwargs)
        MemoConfig(threshold=0.8)        # second call: no second warning
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(dep) == 1
    assert "MemoSpec" in str(dep[0].message)
    assert cfg == MemoSpec.flat(**kwargs)
    assert cfg != MemoSpec.flat(threshold=0.8)
    # the shim instance IS a MemoSpec (engines take it unchanged)
    assert isinstance(cfg, MemoSpec)
    assert cfg.admission.enabled is True
    assert cfg.index.host == "ivf"


def test_shim_supports_dataclass_protocols():
    """The old flat MemoConfig was a plain dataclass; the shim must keep
    dataclasses.replace and the inherited classmethods working."""
    cfg = MemoSpec.flat(threshold=0.8, mode="bucket")
    shim = MemoConfig(threshold=0.8, mode="bucket")
    r = dataclasses.replace(shim, runtime=RuntimeSpec(threshold=0.5,
                                                      mode="bucket"))
    assert r.threshold == 0.5 and r.mode == "bucket"
    assert MemoConfig.flat(threshold=0.8, mode="bucket") == cfg
    assert MemoConfig.from_dict(cfg.to_dict()) == cfg
    assert shim.copy() == cfg


def test_legacy_import_paths_still_work():
    from repro_torch.core import MemoConfig as core_cfg
    from repro_torch.core.engine import MemoConfig as engine_cfg
    from repro_torch.memo import MemoConfig as memo_cfg
    assert engine_cfg is MemoConfig
    assert core_cfg is MemoConfig
    assert memo_cfg is specs_mod.MemoConfig


@pytest.mark.parametrize("kwargs", [
    dict(threshold=0.8, mode="bucket", embed_steps=40, admit=True,
         budget_mb=64.0, apm_codec="f16", index_kind="ivf", nprobe=8,
         device_slack=2.0),
    dict(threshold=0.9, apm_codec="int8"),
    dict(mode="kernel", max_layers=3),
])
def test_memo_config_to_dict_matches_reference(kwargs):
    """``MemoConfig(**kw).to_dict()`` equals the reference's on every
    field the port has (it drops the fields that select a JAX
    implementation, ``RuntimeSpec.interpret`` and ``kernel_impl``)."""
    from repro.memo.specs import MemoConfig as RefConfig
    from repro.memo.specs import _reset_flat_config_warning as ref_reset
    specs_mod._reset_flat_config_warning()
    ref_reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        port = MemoConfig(**kwargs).to_dict()
        ref = RefConfig(**kwargs).to_dict()
    assert set(port) == set(ref)
    for comp, fields in port.items():
        dropped = set(ref[comp]) - set(fields)
        assert dropped <= {"interpret", "kernel_impl"}, (comp, dropped)
        assert fields == {k: v for k, v in ref[comp].items()
                          if k in fields}, comp


# ------------------------------------------------------ configs

def test_rwkv6_optimized_matches_reference():
    from repro.configs import rwkv6_3b as ref_mod
    from repro_torch.configs import rwkv6_3b as port_mod
    port, ref = port_mod.optimized(), ref_mod.optimized()
    want = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    got = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    assert got == want
    assert port.act_shard_batch == ("data", "model")
    assert port.replace(act_shard_batch=None) == port_mod.CONFIG
