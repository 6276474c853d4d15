"""A fixture shared by the K2 test files: torch on one thread for a test."""

import pytest
import torch


@pytest.fixture
def one_thread():
    """torch (and the MKL/OpenMP runtime it shares with the LAPACK calls
    of this process) on one thread for the test: eight threads a test
    process beside other test processes made the wide unions' solves of
    both packages, and loops of small contractions, spin many times
    longer."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
