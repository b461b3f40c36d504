"""Test scaffolding.

The container may lack ``hypothesis``; property tests only use a tiny
slice of its API (``given`` / ``settings`` / three strategies), so when
the real package is missing we register a deterministic shim in
``sys.modules`` before collection. Seeded sampling keeps the property
tests meaningful (many examples per test) and reproducible.
"""
from __future__ import annotations

import sys
import types


def _install_hypothesis_shim():
    import numpy as np

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(lo, hi):
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def floats(lo, hi, **_kw):
        return _Strategy(lambda rng: float(rng.uniform(lo, hi)))

    def sampled_from(xs):
        xs = list(xs)
        return _Strategy(lambda rng: xs[int(rng.integers(0, len(xs)))])

    def settings(max_examples=10, deadline=None, **_kw):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    def given(**strats):
        def deco(fn):
            import inspect

            # parameters NOT drawn from strategies (pytest.mark.parametrize
            # / fixtures) pass straight through; pytest must see exactly
            # those in the signature — not the strategy names, hence the
            # exec-built wrapper instead of functools.wraps
            passthrough = [p for p in inspect.signature(fn).parameters
                           if p not in strats]

            def body(*args):
                # read max_examples lazily: @settings usually sits ABOVE
                # @given, so it decorates (and tags) this wrapper
                n = getattr(wrapper, "_shim_max_examples", 10)
                rng = np.random.default_rng(0)
                kw = dict(zip(passthrough, args))
                for _ in range(n):
                    fn(**kw, **{k: s.draw(rng) for k, s in strats.items()})

            if passthrough:
                ns = {"body": body}
                argstr = ", ".join(passthrough)
                exec(f"def wrapper({argstr}):\n    return body({argstr})", ns)
                wrapper = ns["wrapper"]
            else:
                def wrapper():
                    return body()
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper
        return deco

    hyp = types.ModuleType("hypothesis")
    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.floats = floats
    st_mod.sampled_from = sampled_from
    hyp.given = given
    hyp.settings = settings
    hyp.strategies = st_mod
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st_mod


try:  # pragma: no cover - exercised implicitly at collection time
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (with its reason) on a "
        "machine without one")
