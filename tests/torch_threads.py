"""The port's test files run torch on at most two intra-op threads.

pytest-xdist runs several workers on one host, and torch's default of
one thread per core in each worker oversubscribes it: a 30 s test took
200 s beside five busy workers (tests/test_torch_train.py's note). A
test file imports :func:`two_torch_threads`, a module-scoped autouse
fixture, and its tests run on two threads; the previous count comes
back after the file."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)
