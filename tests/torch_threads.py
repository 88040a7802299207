"""A module fixture for the port's CPU tests: two torch intra-op threads.

The suite runs six pytest workers on the host's cores; with torch's default
of one intra-op thread a core, every worker's threads wait on each other's.
A test file imports the fixture (`from torch_threads import
two_torch_threads`), which then applies to each of its tests and is undone
after its last."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)
