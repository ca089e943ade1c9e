"""The port's test files share one module fixture: import it into a test
module with ``from _torch_threads import one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny models: with PyTorch's default of
    a thread a core, the suite's six workers oversubscribe the cores and
    tiny CPU ops run tens of times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
