"""The port's four examples (``examples/torch_*.py``) on the CPU.

Each runs in a fresh interpreter (one an example, in parallel, one torch
thread each) with ``--device cpu`` at its small size, through its
``main``, which returns what it printed; the interpreter then confirms
that neither ``jax`` nor the reference package was imported. Each
example's own invariant is held: the quickstart's session hits and
serves finite logits; the serving walk-through's self-queries find
themselves (at distance 0 up to f32 rounding), drifted traffic is
admitted, eight entries are evicted and every request is served;
training lowers the loss and writes its checkpoint; a warm-started session serves identical logits
and hits. Without ``--device`` an example asks for the card, and raises
where there is none.
"""
import json
import os
import runpy
import subprocess
import sys

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_quickstart", "torch_serve_memo", "torch_train_memoize",
            "torch_warm_start")

RUN = r"""
import json, runpy, sys
import torch
torch.set_num_threads(1)
path, argv = sys.argv[1], json.loads(sys.argv[2])
res = runpy.run_path(path, run_name="example")["main"](argv)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print("EXAMPLE-RESULT " + json.dumps({"result": res, "imported": bad}))
"""


def _argv(name, tmp):
    argv = ["--device", "cpu"]
    if name == "torch_quickstart":
        argv.append("--small")
    if name == "torch_train_memoize":
        argv += ["--small", "--steps", "30", "--ckpt",
                 os.path.join(tmp, "gpt2_memo.npz")]
    return argv


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("examples"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", RUN,
         os.path.join(REPO, "examples", name + ".py"),
         json.dumps(_argv(name, tmp))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp) for name in EXAMPLES}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("EXAMPLE-RESULT ")]
            assert p.returncode == 0 and line, stderr[-3000:]
            out[name] = json.loads(line[-1][len("EXAMPLE-RESULT "):])
    finally:
        for p in procs.values():
            p.kill()
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_reference(results, name):
    assert results[name]["imported"] == []


def test_quickstart(results):
    r = results["torch_quickstart"]["result"]
    assert r["entries"] > 0 and r["finite"]
    assert 0.0 < r["memo_rate"] <= 1.0
    assert 0.0 <= r["acc_memo"] <= 1.0


def test_serve_memo(results):
    r = results["torch_serve_memo"]["result"]
    # each stored embedding finds itself; its squared L2, |q|² + |d|² −
    # 2 q·d in f32, is 0 up to rounding
    assert r["self_slots"] == [0, 1, 2, 3] and r["self_dist"] <= 1e-2
    assert r["admitted"] > 0 and r["delta_syncs"] > 0
    assert r["evicted"] == 8
    assert r["served"] == r["requests"] == 32


def test_train_memoize(results):
    r = results["torch_train_memoize"]["result"]
    assert r["last_loss"] < r["first_loss"]
    assert os.path.exists(r["ckpt"])
    assert r["entries"] > 0
    assert 0.0 <= r["memo_rate"] <= 1.0 and 0.0 <= r["agreement"] <= 1.0


def test_warm_start(results):
    r = results["torch_warm_start"]["result"]
    assert r["identical"]
    assert r["memo_rate"] == r["memo_rate_offline"]
    assert r["served"] == r["requests"] == 24


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_asks_for_the_card(name, monkeypatch):
    """No ``--device``: the card, and no quiet fallback to the CPU."""
    main = runpy.run_path(os.path.join(REPO, "examples", name + ".py"),
                          run_name="example")["main"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
