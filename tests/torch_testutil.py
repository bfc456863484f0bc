"""Shared setup of the port's test files, ``tests/test_torch_*.py``.

Every port test file takes the fixture below in with one import::

    from tests.torch_testutil import one_intra_op_thread  # noqa: F401

pytest finds an autouse fixture in a module's namespace, so the import is
all a file needs.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Run the module's tests on one intra-op thread, and the processes
    they start too (``OMP_NUM_THREADS=1``); restore both afterwards.

    Tier-1 runs six pytest workers on the machine's cores, and torch gives
    each of them one intra-op thread per core.  The plain versions of the
    kernels are many small operations, whose parallel regions then wait on
    each other's threads across the whole machine: a plain walk took 631 s
    under six workers against 2 s alone.  Each worker runs one file at a
    time (``--dist loadfile``), so the setting reaches no other file's
    tests."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
