"""Multi-process bootstrap: one process per GPU.

The reference scales across nodes through MPI: mpirun launches N ranks,
MPI_Init wires them up (main.cpp:1822-1826), and all communication flows
through mpi_funcs.hpp. The JAX equivalent is its multi-controller runtime:
one process per GPU runs the SAME program, ``jax.distributed.initialize``
connects the processes (gRPC coordination service), ``jax.devices()``
returns the GLOBAL device list, and the existing shard_map/ppermute halo
exchange runs unchanged (NCCL between GPUs) — XLA partitions the program;
no rank-conditional code is needed.

Design notes vs the reference:
  * no matrix scatter (mpi_funcs.hpp:739-860): each process ingests the
    matrix and computes the (deterministic) partition/halo plan itself,
    then materializes only its addressable shards via ``jax.device_put``
    with a global ``NamedSharding``. This trades redundant host planning
    for zero bootstrap communication.
  * result gather (main.cpp:968-990 MPI_Gatherv) becomes
    ``multihost_utils.process_allgather`` in ``to_host``.
  * per-process comm volume (reference -print_comm_vol per rank) is
    derived from the halo plan by grouping mesh positions by owning
    process.

Every process is given the coordinator address (``HOST:PORT`` of process
0), the process count and its own id; nothing detects a cluster by itself.
tests/test_multihost.py runs a real 2-process CPU cluster.
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(
    coordinator: Optional[str] = None,
    n_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_devices: Optional[int] = None,
    platform: Optional[str] = None,
) -> dict:
    """Connect this process to a multi-host cluster. Call once, before the
    first device query. Arguments fall back to USPMV_COORDINATOR /
    USPMV_N_PROCESSES / USPMV_PROCESS_ID.

    ``local_devices`` forces the per-process CPU device count (testing);
    ``platform`` pins the backend ('cpu' keeps a test cluster off any
    GPU of the machine).

    Returns {'process_id', 'n_processes', 'n_devices', 'n_local_devices'}.
    """
    import jax

    coordinator = coordinator or os.environ.get("USPMV_COORDINATOR")
    if n_processes is None and os.environ.get("USPMV_N_PROCESSES"):
        n_processes = int(os.environ["USPMV_N_PROCESSES"])
    if process_id is None and os.environ.get("USPMV_PROCESS_ID"):
        process_id = int(os.environ["USPMV_PROCESS_ID"])

    if platform:
        jax.config.update("jax_platforms", platform)
    if local_devices:
        jax.config.update("jax_num_cpu_devices", int(local_devices))

    # explicit cluster arguments require the coordinator address: jax's
    # auto-detection cannot fill it in when the process count/id came from
    # our flags, and letting it fail inside jax.distributed produces a
    # confusing internal error instead of naming the missing flag
    if (n_processes is not None or process_id is not None) and not coordinator:
        raise ValueError(
            "-coordinator HOST:PORT is required when -n_processes or "
            "-process_id is given explicitly (process 0's host)"
        )
    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if n_processes is not None:
        kwargs["num_processes"] = int(n_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    jax.distributed.initialize(**kwargs)
    return {
        "process_id": jax.process_index(),
        "n_processes": jax.process_count(),
        "n_devices": len(jax.devices()),
        "n_local_devices": len(jax.local_devices()),
    }


def is_multiprocess() -> bool:
    import jax

    try:
        return jax.process_count() > 1
    except Exception:
        return False


def fetch_global(y):
    """np.asarray for possibly non-fully-addressable arrays: gathers the
    missing shards from their owning processes (the Gatherv analogue,
    main.cpp:968-990)."""
    import jax
    import numpy as np

    if isinstance(y, jax.Array) and not y.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(y, tiled=True))
    return np.asarray(y)
