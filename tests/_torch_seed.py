"""Per-test seeding of the port's generator.

conftest's `_seed_rng` seeds numpy and the JAX package's generator for
every test and logs the seed in ``request.node.user_properties``. The
port's generator (`mxnet_tpu_torch.random`, which `initialize()` draws
from) is seeded here with that same seed, so a port test's weights do not
depend on what earlier tests in its worker drew. A test file takes the
fixture by importing it:

    from _torch_seed import _seed_torch  # noqa: F401
"""
import pytest


@pytest.fixture(autouse=True)
def _seed_torch(_seed_rng, request):
    import mxnet_tpu_torch as mx
    seed = dict(request.node.user_properties)["mxnet_test_seed"]
    mx.random.seed(seed)
    yield
