"""Fixtures of the benchmark's own tests (run with
`python -m pytest benchmark/tests -q` from the repository root)."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture
def cuda():
    """The card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    from benchmark.tests import tiny

    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))
