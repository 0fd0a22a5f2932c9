"""Test configuration: CPU by default, with an 8-device virtual CPU mesh
so multi-device sharding logic is exercised without accelerators
(SURVEY §4). Set JAX_PLATFORMS (e.g. `cuda`) to run the `gpu`-marked
tests on a card."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))  # oracle/synthdata helpers

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def make_genome(rng, length=20000, seed=7):
    """Deterministic random genome sequence."""
    r = np.random.default_rng(seed)
    return "".join(r.choice(list("ACGT"), size=length))


@pytest.fixture
def genome():
    return make_genome(None)


@pytest.fixture
def gpu():
    """The GPU the `gpu`-marked tests run on; skips when JAX's default
    device is not one (decided here, at run time, never at import)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/` on the card")
    return dev
