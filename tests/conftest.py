import os

# Tests run on the CPU backend with 8 virtual devices (for the mesh tests);
# XLA_FLAGS must be set before the CPU client initializes. Whatever needs a
# GPU runs in chip_smoke.py, not here.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
