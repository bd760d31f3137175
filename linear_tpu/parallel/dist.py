"""Multi-host wiring, import-light on purpose.

jax.distributed.initialize() must run before ANYTHING initializes the XLA
backend, and several linear_tpu.ops modules create small device constants
at import time — so this module imports only jax itself, and multi-process
entry points must `from linear_tpu.parallel.dist import init_distributed`
and call it BEFORE importing linear_tpu.parallel.mesh / linear_tpu.ops.

Reference analog: none — the reference is single-node OpenMP (SURVEY
§2.3); this wires the multi-process runs of tools/*multiproc.py.
"""
from __future__ import annotations

import os


def init_distributed() -> int:
    """Initialize jax.distributed from the standard env
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) so a
    multi-process run sees one global mesh (dp over all devices). No-op single-process when the env is absent.
    Returns the process index (0 when not distributed)."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return 0
    import jax

    n = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=addr, num_processes=n,
                               process_id=pid)
    return pid
