"""Multi-host decode: jax.distributed process groups + global meshes.

The reference has no distributed machinery at all (SURVEY.md §2); this
module provides the equivalent: a ``jax.distributed`` runtime where each
host contributes its local devices to a global ``('data', 'seg')`` mesh —
images shard across hosts, restart segments across the devices of a host,
exactly the layout full_decode_step expects.

Multi-process correctness is exercised without a cluster via two local CPU
processes (tests/test_multihost.py), the standard JAX trick: shard_map code
is identical on a CPU mesh and on a multi-host GPU mesh.
"""

from __future__ import annotations

import numpy as np

import jax


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None):
    """Join (or form) a jax.distributed process group.

    Call BEFORE any jax computation.  For CPU-based testing set
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in the
    environment first so each process contributes N virtual devices.
    """
    kwargs = dict(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    if local_device_count is not None:
        kwargs["local_device_count"] = local_device_count
    jax.distributed.initialize(**kwargs)


def global_mesh(seg_per_host: int | None = None):
    """Global ('data', 'seg') mesh: hosts on 'data', per-host devices on
    'seg'.  Requires all hosts to have the same local device count."""
    from jax.sharding import Mesh

    devices = jax.devices()
    n_proc = jax.process_count()
    per_host = len(devices) // n_proc
    if seg_per_host is None:
        seg_per_host = per_host
    arr = np.array(devices).reshape(n_proc * per_host // seg_per_host,
                                    seg_per_host)
    return Mesh(arr, ("data", "seg"))


def local_data_rows(mesh, batch: int) -> list[int]:
    """The rows of a 'data'-sharded batch owned by this process (assuming
    hosts-major mesh construction as in :func:`global_mesh`)."""
    n_data = mesh.shape["data"]
    per = -(-batch // n_data)
    # data coordinates owned by this process:
    mine = [i for i in range(n_data)
            if mesh.devices[i, 0].process_index == jax.process_index()]
    out = []
    for i in mine:
        out.extend(range(i * per, min((i + 1) * per, batch)))
    return out
