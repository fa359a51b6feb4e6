import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="module")
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=["dense2k.long_e", "wide2k.pe150_six"])
def session(request, tmp_path_factory, cpu_threads):
    """A CPU session of each tiny cell (the port's plain versions)."""
    return tiny.session(request.param, str(tmp_path_factory.mktemp("cache")))
