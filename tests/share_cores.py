"""Torch's intra-op threads shared among a test run's worker processes.

Under ``pytest -n N`` each worker would start as many torch threads as the
machine has cores, and N such workers oversubscribe the cores and spin
against each other: on 8 cores under ``-n 6`` the port's heaviest test
files ran 5-8x slower than alone. A test file that imports ``share_cores``
gives its worker its share of the cores while the file's tests run and
restores the count after; run without xdist, nothing changes.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, before // workers))
    yield
    torch.set_num_threads(before)
