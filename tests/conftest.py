import os

import pytest

# The suite runs on a virtual 8-device CPU mesh: fast, deterministic, and it
# exercises the same sharding code paths as a multi-GPU host. chip_smoke.py
# runs the `gpu`-marked tests on the card in its own process, after JAX has
# already started there; it sets AMIRA_TPU_TESTS_ON_DEVICE so the platform
# it chose is left alone.
if not os.environ.get("AMIRA_TPU_TESTS_ON_DEVICE"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips elsewhere (run by `python chip_smoke.py`)",
    )


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_card(request):
    """Whether a card is present is decided here, per test, never at import
    or collection time, so every xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through `python chip_smoke.py`)")
