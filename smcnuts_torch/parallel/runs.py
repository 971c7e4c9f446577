"""The run axis over a process group (the JAX package's `parallel/runs.py`).

Independent Monte-Carlo runs need no communication: `map_runs` gives each
of the P ranks R / P of the R seeds, in order, runs them as one batch
(`run_smc_batched`, one NUTS launch an iteration), and gathers the results
once at the end. Since run b of a batch equals its run alone to the bit,
the gathered result equals `run_smc_batched` of all R seeds to the bit.

Both axes combine on a grid (`runs_particles_mesh` + `map_runs_2d`): the
ranks form rows of equal size, each row a sub-group (`torch.distributed.
new_group`) that shards its runs' particles (`parallel.sharding`), while the
runs spread over the rows.

The JAX package's `run_mesh()` has no counterpart of its own: the ranks of
a group are `sharding.particle_group()`, whichever axis they carry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .sharding import ParticleGroup, gather_result, particle_group, shard_group

RUN_AXIS = "runs"


def _gather_runs(result, group: ParticleGroup):
    """Every rank's result fields concatenated along the run axis, in rank
    order (None fields stay None)."""
    return type(result)(**{
        name: None if v is None else torch.cat(group.all_gather(v))
        for name, v in result._asdict().items()})


def _split(seeds, parts: int, index: int) -> list:
    seeds = [int(s) for s in seeds]
    if len(seeds) % parts:
        raise ValueError(f"run count {len(seeds)} must be a multiple of {parts}")
    per = len(seeds) // parts
    return seeds[index * per:(index + 1) * per]


def map_runs(model, cfg, seeds, group: ParticleGroup, **kwargs):
    """R = len(seeds) runs over the ranks of `group`: R / P a rank through
    `run_smc_batched`, no communication, one gather of the results; every
    rank returns the SMCResult of all R runs (each field leads with R),
    equal to `run_smc_batched(model, cfg, seeds)` to the bit. kwargs go to
    run_smc_batched."""
    from ..sampler import run_smc_batched

    mine = _split(seeds, group.size, group.rank)
    res = run_smc_batched(model, cfg, mine, group.device, **kwargs)
    return _gather_runs(res, group)


@dataclass
class RunGrid:
    """The ranks as `rows` rows of `cols`: this rank sits in row `row`,
    column `col`; `particles` shards its row's particles, `world` spans
    every rank."""

    rows: int
    cols: int
    row: int
    col: int
    particles: ParticleGroup
    world: ParticleGroup


def runs_particles_mesh(n_run_rows: int, group=None, device=None) -> RunGrid:
    """A grid of `n_run_rows` rows over the ranks of a process group (None:
    the default); rank r sits in row r // cols. Every rank must call it (each
    row's sub-group is made collectively)."""
    world = particle_group(group, device)
    if world.size % n_run_rows:
        raise ValueError(f"{world.size} ranks do not form {n_run_rows} equal rows")
    cols = world.size // n_run_rows
    mine = None
    for row in range(n_run_rows):
        ranks = [dist.get_global_rank(group, r) if group is not None else r
                 for r in range(row * cols, (row + 1) * cols)]
        sub = shard_group(world, ranks)
        if sub is not None:
            mine = sub
    return RunGrid(n_run_rows, cols, world.rank // cols, world.rank % cols, mine, world)


def map_runs_2d(model, cfg, seeds, grid: RunGrid, **kwargs):
    """R = len(seeds) runs over the grid's rows (R / rows a row, in order),
    each row sharding its runs' particles over its columns; every rank
    returns the SMCResult of all R runs with the particles in the global
    order, equal to `run_smc_batched(model, cfg, seeds)` to the bit."""
    from ..sampler import run_smc_batched

    mine = _split(seeds, grid.rows, grid.row)
    res = gather_result(run_smc_batched(model, cfg, mine, grid.particles.device,
                                        group=grid.particles, **kwargs), grid.particles)
    # Every rank of a row now holds the row's runs whole; gather over all
    # ranks and keep one copy a row.
    everyone = _gather_runs(res, grid.world)
    per = len(mine)
    keep = [r * grid.cols * per + i for r in range(grid.rows) for i in range(per)]
    return type(res)(**{name: None if v is None else v[keep]
                        for name, v in everyone._asdict().items()})
