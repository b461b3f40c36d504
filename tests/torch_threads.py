"""One intra-op thread for the port's CPU tests.

The suite runs under ``pytest -n 6`` on a few cores. Left at its
default, every worker's torch opens one OpenMP thread a core, so six
workers keep several times as many spinning threads as there are cores,
and the small ops of a reduced model wait on each other: a launcher case
that takes 1.4 s alone took 346 s in a full run. Each port test module
imports ``one_torch_thread``, an autouse fixture that holds torch to one
thread while the module runs and gives the old count back after it.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
