"""Device-mesh helpers for fleet-scale planning.

The reference's only parallelism is a 6-process fork over candidate chunks
(reference: reactive_planner.py:1084-1111); this build parallelizes the
candidate axis on-chip and scales over SCENARIOS via a device mesh
(SURVEY.md section 2.3).  These helpers build the mesh and shardings.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


FLEET_AXIS = "fleet"


def make_fleet_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the fleet (scenario) axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (FLEET_AXIS,))


def fleet_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (fleet) axis across the mesh."""
    return NamedSharding(mesh, PartitionSpec(FLEET_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-host runtime bring-up (jax.distributed).

    1-chip -> 1-host -> N-host scaling path (SURVEY.md section 2.3).  No-op
    when no coordinator is given and JAX's auto-detection applies.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
