import sys
from pathlib import Path

import pytest
import torch

# the port under test, for `pytest perfbench` without PYTHONPATH=src
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny runs take one CPU thread each, so that the test workers
    running beside them are not starved."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
