"""Test configuration: force JAX onto a virtual 8-device CPU mesh so
sharding/parallelism tests run anywhere (mirrors how the reference tests
without special hardware; see SURVEY.md §4)."""

import os

# Must be set before jax is imported by any test module: tests always
# run on a virtual 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except ImportError:
    pass

import pathlib

import pytest

ASSETS = pathlib.Path(__file__).parent / "assets"


@pytest.fixture(scope="session")
def halfmoonbay_bytes() -> bytes:
    return (ASSETS / "halfmoonbay.heic").read_bytes()
