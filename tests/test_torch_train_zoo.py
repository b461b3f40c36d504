"""``Model.train_loss`` and its grads against the JAX package's for the
rest of the zoo (MLA, MoE, the RG-LRU hybrid, rwkv6, the enc-dec whisper
with frames); the tolerances and the forced routes are
``tests/test_torch_train.py``'s."""
import pytest

from test_torch_train import ZOO, refs  # noqa: F401 (module-scoped fixture)
from test_torch_train import test_train_loss_and_grads_match_reference as _one
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ZOO)
def test_train_loss_and_grads_match_reference_zoo(arch, refs):  # noqa: F811
    _one(arch, refs)
