"""One intra-op thread for the port's CPU tests.

The suite runs its files on several pytest-xdist workers at once (`-n 6
--dist loadfile`), and torch's default intra-op pool in each worker takes
every core. The pools then oversubscribe the machine: on 8 cores, six
copies of tests/test_torch_tracking.py (23 s alone) did not finish within
400 s; pinned to one thread each, they finished in 43-45 s. The port's CPU
work is many small ops, which gain little from a pool anyway.

Every CPU test file `tests/test_torch_*.py` takes the fixture with one
import:

    from torch_threads import one_torch_thread  # noqa: F401

An autouse fixture applies to the module that defines or imports it, and
to no other. The card-only files (`*_cuda.py`) run with `--noconftest` on
the card and do not import it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
