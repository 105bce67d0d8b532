"""Test config: run all tests on a virtual 8-device CPU mesh.

Mirrors the reference's single-machine multi-rank testing gap (SURVEY.md §4):
we use XLA's host-platform device virtualization as the JAX analog of gloo.

Note: jax is pre-imported at interpreter startup in this image, so env vars
are too late — use jax.config.update before any backend is initialized.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (multi-process spawns)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True, scope="session")
def _assert_cpu():
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the virtual CPU mesh; got %s" % jax.devices())
    assert jax.device_count() == 8
    yield


@pytest.fixture(autouse=True)
def _reset_global_mesh():
    """Undo any jax.sharding.set_mesh a test (or code under test) leaves
    behind: a leaked concrete mesh makes later traces mix meshes
    (ShardingTypeError: 'Mesh for all inputs should be equal')."""
    prev = jax.sharding.get_mesh()
    yield
    if jax.sharding.get_mesh() is not prev:
        jax.sharding.set_mesh(prev)
