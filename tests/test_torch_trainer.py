"""The port's ``Trainer`` against the JAX package's: ``fit`` from the same
params and batches (AdamW, Adafactor on a MoE, grad accumulation, the
classifier loss), its checkpoints, and its config checks.

Tolerance: the losses at every step within 1e-4 relative of the
reference's (f32 steps summed in another order, compounded over 5
optimizer steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.tree import flat_params
from test_torch_train import B, CPU, _batch, _np_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIT_RTOL = 1e-4


def _fit_both(arch, tcfg_kw, n_batches, classes=0, accum=1):
    """5 steps of the reference's ``Trainer`` and the port's from the same
    params and batches; returns both histories and the port's result."""
    jcfg = jax_get_reduced(arch)
    if classes:
        jcfg = jcfg.replace(n_classes=classes)
    cfg = get_reduced(arch)
    if classes:
        cfg = cfg.replace(n_classes=classes)
    jm = jax_build_model(jcfg)
    params = _np_tree(build_model(cfg, device=CPU).init(3))
    jp = jax.tree.map(jnp.asarray, params)
    batches = [_batch(jcfg, 10 + i, n=B * accum, classes=classes)
               for i in range(n_batches)]
    if accum > 1:
        batches = [{k: v.reshape((accum, B) + v.shape[1:])
                    for k, v in b.items()} for b in batches]
    jt = JaxTrainer(jm, JaxTrainConfig(**tcfg_kw))
    _, _, jhist = jt.fit(jp, iter([jax.tree.map(jnp.asarray, b)
                                   for b in batches]), on_log=lambda m: None)
    tr = Trainer(build_model(cfg, device=CPU), TrainConfig(**tcfg_kw))
    logs = []
    out = tr.fit(tree_to_torch(params, CPU), iter(batches),
                 on_log=logs.append)
    assert len(logs) == len(out[2])
    return jhist, out


@pytest.mark.parametrize("case", ["gpt2_adamw", "dbrx_adafactor",
                                  "grad_accum_2", "classify"])
def test_fit_matches_reference(case):
    arch, kw, extra = {
        "gpt2_adamw": ("gpt2_small", {}, {}),
        "dbrx_adafactor": ("dbrx_132b", {"optimizer": "adafactor"}, {}),
        "grad_accum_2": ("gpt2_small", {"grad_accum": 2}, {"accum": 2}),
        "classify": ("bert_base", {"loss": "classify"}, {"classes": 4}),
    }[case]
    kw = dict(steps=5, lr=1e-3, warmup=2, log_every=1, **kw)
    jhist, (params, opt_state, hist) = _fit_both(arch, kw, 5, **extra)
    assert [i for i, _ in hist] == [i for i, _ in jhist] == list(range(5))
    for (_, lv), (_, jv) in zip(hist, jhist):
        assert abs(lv - jv) <= FIT_RTOL * abs(jv), (hist, jhist)
    assert opt_state["t"] == 5


def test_ckpt_every_loads_in_reference(tmp_path):
    from repro.train.checkpoint import load_checkpoint as jax_load
    cfg = get_reduced("gpt2_small")
    model = build_model(cfg, device=CPU)
    tr = Trainer(model, TrainConfig(
        steps=5, log_every=10, ckpt_every=2,
        ckpt_path=str(tmp_path / "model")))
    params, _, hist = tr.fit(model.init(0),
                             iter([_batch(cfg, i) for i in range(5)]),
                             on_log=lambda m: None)
    assert [i for i, _ in hist] == [0, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["model_2.npz", "model_4.npz"]
    jparams, opt, meta = jax_load(str(tmp_path / "model_4.npz"))
    assert meta["step"] == 4 and opt is None
    jflat = flat_params(jparams)
    for k, v in flat_params(params).items():
        np.testing.assert_array_equal(np.asarray(jflat[k]), v.numpy(), k)


def test_trainer_rejects_unknown_loss():
    with pytest.raises(ValueError, match="loss must be one of"):
        Trainer(build_model(get_reduced("gpt2_small"), device=CPU),
                TrainConfig(loss="mse"))
