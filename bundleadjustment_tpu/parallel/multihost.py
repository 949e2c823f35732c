"""Multi-host initialization helpers.

JAX's answer to "NCCL/MPI setup" (SURVEY.md §2.3): its distributed runtime
handles cross-host coordination; collectives run over NVLink within a host
and over the network across hosts once `jax.distributed.initialize` has run
on every host.  This module is the thin, testable wrapper the pipeline
and benchmarks call; on a single host it is a no-op.
"""

from __future__ import annotations

import os


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Initialize jax.distributed from args or standard env vars.

    No-op when neither args nor env (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a cluster environment jax
    auto-detects) indicate a multi-process run.  Returns True if the
    distributed runtime was initialized.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(axis_name="shard"):
    """1-D mesh over ALL devices across hosts (for the sharded Schur BA)."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))


def host_local_mesh(axis_name="shard"):
    """1-D mesh over this host's local devices only."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.local_devices()), (axis_name,))
