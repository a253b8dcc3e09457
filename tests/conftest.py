"""Test configuration: JAX runs on a virtual 8-device CPU mesh, so the suite is
hermetic and fast.  Tests marked `gpu` need an NVIDIA GPU.  They run only when
MAPPER_TPU_TESTS_ON_DEVICE=1 leaves JAX on its default platform (chip_smoke.py
sets it on the machine with the card) and skip otherwise; whether a card is
present is decided inside a fixture, never at import or collection."""

import os

import pytest

ON_DEVICE = os.environ.get("MAPPER_TPU_TESTS_ON_DEVICE") == "1"

if not ON_DEVICE:
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")

import mapper_tpu  # noqa: E402,F401  (configures the persistent compile cache)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; run with MAPPER_TPU_TESTS_ON_DEVICE=1 "
        "(python chip_smoke.py runs them on the card)",
    )


@pytest.fixture(autouse=True)
def _gpu_marker_needs_a_gpu(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: run `MAPPER_TPU_TESTS_ON_DEVICE=1 python -m "
            "pytest tests -m gpu` on the card (chip_smoke.py does)"
        )
