"""The port's CPU test modules' shared fixture: one torch thread a module.

A module imports ``one_torch_thread`` to use it (an autouse fixture
applies to every module whose namespace holds it)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These modules make many small forwards and decodes on the CPU,
    which gain nothing from torch's intra-op threads (21 s with eight,
    27 s with one, in one process, for ``test_torch_drivers.py``); beside
    the suite's other parallel workers those threads only contend for the
    cores.  One thread for the module, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
