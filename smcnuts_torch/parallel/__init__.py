"""The particle axis and the run axis over a torch.distributed process group
(the JAX package's `parallel/`, whose device mesh becomes a process group).

- `sharding`: `ParticleGroup`, `particle_group()` (the JAX `particle_mesh()`)
  and the collectives of the SMC ops; a sharded run equals the unsharded
  one to the bit.
- `runs`: `map_runs` (independent runs spread over the ranks) and the grid
  of runs x particles (`runs_particles_mesh`, `map_runs_2d`).
- `multihost`: `initialize()` and the multi-process entry.
- `elastic`: `Supervisor`, a gang restarted from its checkpoint.
"""

from .elastic import Supervisor
from .runs import RUN_AXIS, RunGrid, map_runs, map_runs_2d, runs_particles_mesh
from .sharding import (
    PARTICLE_AXIS,
    ParticleGroup,
    fetch_rows,
    gather_particles,
    gather_result,
    group_row_sum,
    particle_group,
    shard_group,
)

__all__ = [
    "PARTICLE_AXIS",
    "ParticleGroup",
    "RUN_AXIS",
    "RunGrid",
    "Supervisor",
    "fetch_rows",
    "gather_particles",
    "gather_result",
    "group_row_sum",
    "map_runs",
    "map_runs_2d",
    "particle_group",
    "runs_particles_mesh",
    "shard_group",
]
