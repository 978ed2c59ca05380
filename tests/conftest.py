"""Test configuration: force the CPU backend with 8 virtual devices so
multi-device sharding tests run anywhere (the driver validates the
multi-device path separately via __graft_entry__.dryrun_multichip).

The config is updated after importing jax as well, so a JAX_PLATFORMS set
by the caller's environment cannot select another backend. Tests that
need an NVIDIA GPU are marked ``gpu`` and skip on the CPU; run them on
the card with ``python -m pytest tests -m gpu``, which leaves the default
backend alone.
"""

import os


def pytest_configure(config):
    if config.getoption("markexpr", "") == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
