"""Test configuration: 8 fake CPU devices + float64 golden path.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4 'multi-node testing')
so sharding/collective logic is exercised without accelerators, and with x64
enabled so accuracy tests can assert the reference's float64 tolerances
(reference tests /root/reference/tests/test_fem.py use atol 1e-9..1e-12).
Tests marked ``gpu`` compile a kernel for a real GPU; the ``gpu_device``
fixture skips them where there is none.
"""

import os

# Tests run on the virtual 8-device CPU mesh unless JAX_PLATFORMS names
# another platform (the ``gpu`` tests on a machine with a card).  XLA_FLAGS
# is read lazily at CPU-backend init, so setting it here (before the first
# jax op) still takes effect.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from difffe_tpu.mesh import FEMesh  # noqa: E402


@pytest.fixture
def line_mesh_10():
    # mirrors reference fixture test_fem.py:30-32
    return FEMesh.line(n_elements=10)


@pytest.fixture
def line_mesh_100():
    # mirrors reference fixture test_fem.py:34-36
    return FEMesh.line(n_elements=100)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none.  Decided here,
    at run time, so every xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: the kernel is compiled for the card "
                    "(chip_smoke.py runs the same check there)")
    return devs[0]
