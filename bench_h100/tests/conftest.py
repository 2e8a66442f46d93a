import pytest


@pytest.fixture
def card():
    """The CUDA device, decided when a test asks for it; card tests skip
    without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card (bench_h100/README.md)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
