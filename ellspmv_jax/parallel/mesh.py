"""Device mesh construction.

The reference's parallel resource is the OpenMP thread team
(ellspmv.c:1746, 1821); here it is a 1-D `jax.sharding.Mesh` over
devices. Every device reaches every other at the same rate, so one flat
axis named 'rows' suffices for SpMV: A is row-sharded, x is allgathered,
y stays sharded (SURVEY §2.4 'distributed comm backend').
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "rows") -> Mesh:
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have "
                         f"{len(devices)} (use XLA_FLAGS="
                         "--xla_force_host_platform_device_count=N on CPU)")
    import numpy as np
    return Mesh(np.array(devices[:n_devices]), (axis,))
