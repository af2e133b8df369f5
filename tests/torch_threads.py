"""Intra-op thread fixtures shared by the port's test files.

A test module takes them by importing them (pytest registers a fixture
where it is imported): ``from torch_threads import one_thread  # noqa:
F401``. ``one_thread`` is autouse and module-scoped: the port's smoke
models, scans, decode loops and plain solves are loops of small ops,
which run fastest on one intra-op thread (on the CPU, under 6 xdist
workers, many threads a worker only contend for the cores).
"""
import pytest
import torch

# the process's intra-op threads when the tests were collected
THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one intra-op thread; the previous count
    restored after them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def process_threads():
    """One test on the process's own intra-op threads (inside a module
    under :func:`one_thread`): for a test whose numbers are held to the
    summation order those threads give."""
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(1)
