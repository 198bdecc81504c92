"""Device mesh helpers.

The reference's parallelism is "HPC array job" style: N independent OS
processes with hand-assigned seeds, reduced offline by CSV merging
(SURVEY.md section 2).  The equivalent here is a single
``jax.sharding.Mesh`` over all cards with the Monte Carlo batch sharded
along one axis ("batch") and integer error counters reduced with ``psum``
-- the whole of tools/combine_data.py becomes one collective.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = BATCH_AXIS) -> Mesh:
    """One-axis data-parallel mesh over the given (default: all) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis: int = 0,
                   axis_name: str = BATCH_AXIS) -> NamedSharding:
    """Shard array dimension ``axis`` across the mesh's batch axis."""
    spec = [None] * (axis + 1)
    spec[axis] = axis_name
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
