"""Shared fixture of the port's tests: torch on a shared CPU is far slower
with its default thread count than with two, so each test module of the
port runs with two and restores the count afterwards."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
