"""JAX runtime configuration shared by the device modules.

Enables the persistent compilation cache so the XLA compiles of the
seeding / chaining / extension kernels are paid once per checkout instead
of once per process. Called by linear_tpu.ops modules at import (host-only
code paths never import them).

The cache lives where JAX_COMPILATION_CACHE_DIR says; otherwise in
`<checkout>/.jax_cache`, a fixed path (the directory is part of the cache
key, so a path that moves never hits)."""
from __future__ import annotations

import os
import sys

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

_done = False


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def configure() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    d = cache_dir()
    try:
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except (OSError, AttributeError, ValueError) as e:
        print(f"W: JAX compilation cache not configured at {d}: {e}",
              file=sys.stderr)


def accel_device():
    """The first JAX device, for `--device accel` runs. JAX falls back to
    its CPU backend when an accelerator plugin fails to start; that must
    not pass as a device run, so a CPU device is refused unless the caller
    asked for it with JAX_PLATFORMS=cpu (how the tests run). Starts the
    JAX backend: callers that fork a worker pool do so first."""
    import jax

    dev = jax.devices()[0]
    wanted = [p.strip() for p in os.environ.get("JAX_PLATFORMS", "").split(",")]
    if dev.platform == "cpu" and wanted != ["cpu"]:
        raise RuntimeError(
            "--device accel found no accelerator (JAX backend is cpu); set "
            "JAX_PLATFORMS=cpu to run the device path on the CPU on purpose")
    return dev
