"""Multi-host execution: jax.distributed glue + host-0 frame assembly.

The JAX equivalent of the reference's master/worker topology across hosts
(SURVEY.md §2 "Distributed communication backend"):
  - `initialize()` wraps jax.distributed.initialize — the analog of the
    worker registration loop (worker/distributed/main.go:146-185); the JAX
    multi-controller runtime replaces the registrar/heartbeat machinery
    (membership is gang-scheduled, failures fail the slice).
  - process 0 plays the master's role (input, assembly, display,
    master/main.go:189-326); `gather_frame` brings the row-sharded
    framebuffer to host 0 (the analog of coordinator tile reassembly,
    main.go:163-177).

Single-process mode works unchanged: a 1-host "cluster" is just the local
mesh, so everything here is exercised by the test suite on the 8-device CPU
mesh without real DCN.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-host gang (no-op for single-process runs).

    Reads the standard JAX env configuration when args are omitted; the
    reference's equivalent is the worker's register-retry loop — here the
    runtime blocks until the full gang is present.
    """
    if num_processes is None and coordinator_address is None:
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_master() -> bool:
    """Whether this process plays the master's role (host 0)."""
    return jax.process_index() == 0


def global_mesh(axis: str = "tiles") -> jax.sharding.Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return jax.make_mesh((len(jax.devices()),), (axis,))


def gather_frame(frame) -> Optional[np.ndarray]:
    """Assemble a (possibly sharded) framebuffer on host 0.

    Returns the full frame on the master process, None elsewhere — the
    equivalent of the coordinator painting tiles into the SDL surface.
    """
    if jax.process_count() == 1:
        return np.asarray(frame)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(frame, tiled=True)
    return np.asarray(gathered) if is_master() else None
