"""A module-scoped autouse fixture for the port's CPU tests: torch runs
its operators on one thread for the module's tests, then gets back the
count it had. The tests' tensors are small and gain nothing from
intra-op threads; under the suite's parallel workers those threads only
contend for the cores (on an 8-core CPU host, `test_torch_t5.py::
test_engine_matches_jax_staged_trainer[2]` took 2.4 s alone, 45 s beside
seven busy processes with the default count and 3.1 s there with one
thread)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
