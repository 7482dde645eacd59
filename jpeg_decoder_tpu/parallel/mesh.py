"""Device-mesh helpers.

The decode workload has two natural parallel axes (SURVEY.md §2 table):

* ``data`` — independent images (pure DP; the reference decodes one image per
  process, jpeg.cpp:924).
* ``seg``  — restart segments within a scan (the decode-domain analogue of
  sequence/context parallelism; enabled by DC-predictor resets at RSTn,
  jpeg.cpp:419-425).

The mesh shape follows the algorithm: the GPUs of one host are joined all
to all by NVLink, so any (data, seg) split of them costs the same per byte.
Across hosts, lay ``data`` over hosts and ``seg`` over the devices of a
host, so segment-assembly collectives stay inside a host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(shape: tuple[int, ...] = None,
              axis_names: tuple[str, ...] = ("data", "seg"),
              devices=None) -> Mesh:
    """Build a mesh over available devices.

    Default: all devices on one ``seg``-major mesh ``(1, n_devices)`` —
    single-host segment parallelism.  Multi-host callers pass an explicit
    shape like ``(n_hosts, devices_per_host)``.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names)


def single_axis_mesh(name: str = "seg", devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (name,))
