"""Root test setup shared by every test directory.

jax 0.9 dropped ``jax.experimental.enable_x64`` in favour of
``jax.enable_x64``; the reference package and its tests still import the
old name.  Alias it here so the reference imports unchanged.  Where jax is
absent (a host that runs only the PyTorch port) this does nothing.
"""
import pytest

try:
    import jax
    import jax.experimental
except ImportError:  # pragma: no cover - hosts without jax
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of the "
        "PyTorch port); skips where none is visible")


@pytest.fixture
def cuda_device():
    """The GPU for tests of the port's CUDA kernels; skips without one."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels run only there")
    return torch.device("cuda")
