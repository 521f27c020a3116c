"""A fixture for the port's test modules that run many small CPU ops:
import `one_torch_thread` into the module and it applies to every test
there."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while the module runs. Beside other test workers
    on the same cores, each small op's parallel region waits for threads
    the other processes hold, which made these modules' tests 50–200×
    slower than alone. The numbers compared are the same, within each
    test's tolerance or bit for bit between two runs of this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
