"""Multi-host runtime initialization and pod mesh construction.

The analog of the reference's MPI bootstrap (include/dist.h:29-42
initialize_mpi + MPI_COMM_WORLD) and NVSHMEM attr init
(multigpu_nvshmem.cu:94): jax.distributed brings up the multi-process
runtime; the mesh is laid out host-major so the graph axis keeps
neighbouring shards on one host and only crosses the network between
hosts at host boundaries."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op in single-process runs."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None and num_processes is None:
        return False  # single-process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def pod_mesh(axis: str = "graph", *, devices=None):
    """1-D mesh over every device of every process, ordered host-major
    so neighboring shards share a host and the halo all_to_all crosses
    hosts only at host boundaries."""
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    devs = sorted(devices, key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))


def hybrid_mesh(graph_axis: str = "graph", model_axis: str = "model",
                *, model_parallelism: int = 1, devices=None):
    """2-D (graph x model) mesh: graph sharding over hosts, the model
    axis (feature-dimension tensor parallelism for very wide feature
    matrices) confined to devices of one host."""
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    devs = sorted(devices, key=lambda d: (d.process_index, d.id))
    n = len(devs)
    assert n % model_parallelism == 0
    arr = np.array(devs).reshape(n // model_parallelism, model_parallelism)
    return Mesh(arr, (graph_axis, model_axis))
