"""The particle axis over a `torch.distributed` process group (the JAX
package's `parallel/sharding.py`).

The JAX package shards the particle axis over a device mesh and lets GSPMD
insert the collectives; its sharded run differs from the unsharded one in
the last bits (GSPMD reorders the sums, and each device's kernel seed is
offset). Here every collective is explicit, and a sharded run equals the
unsharded run to the bit:

- Layout. Rank i of P holds the global particles i, i + P, i + 2P, ...
  (cyclic), P a power of two dividing N. `ops.reduce.row_sum` folds a
  vector as v[:half] + v[half:] from a power of two down, so rank i's
  local fold is exactly the global fold's entry i after log2(N / P) levels;
  `row_sum(v, group)` then gathers the P partials and folds them in rank
  order, the global fold's last log2(P) levels, and gives the global sum's
  bits.
- Maxima (the logsumexp's shift) are exact under an all-reduce.
- Resampling (`ops.resampling`) gathers the N weights
  (`gather_particles`), computes the CDF on every rank identically,
  inverts it at the rank's own particles' uniforms (addressed by global
  index, `ops.draws`), and fetches the ancestors' rows from their owners
  (`fetch_rows`, an all-to-all of the rows asked for), only in the
  iterations where some run resamples.
- The NUTS trees address their draws by global particle index: the shard's
  `particle_map` (offset, stride) goes to the kernel and its plain version.

The group below holds the layout and the raw collectives (all-gather,
max, all-to-all); the ops own what they do with them.

Backends follow the device: NCCL on `cuda`, one rank a card, device
`cuda:{LOCAL_RANK}`; gloo on the CPU, and on a card only where the caller
names it (several ranks sharing one card). Nothing falls back: a CUDA tensor
handed to a CPU group raises, and a failing collective raises.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..ops.reduce import row_sum
from ..ops.resampling import fetch_rows, gather_particles

__all__ = ["PARTICLE_AXIS", "ParticleGroup", "fetch_rows", "gather_particles",
           "gather_result", "group_row_sum", "particle_group", "shard_group"]

PARTICLE_AXIS = "particles"


@dataclass
class ParticleGroup:
    """A process group that shards the particle axis: rank `rank` of `size`
    holds the particles rank, rank + size, ... of every run, on `device`.

    `group` is the torch.distributed process group (None: the default
    group). `stats` counts what the collectives of this group moved: calls,
    the bytes this rank received ("bytes_in") and the host seconds inside the
    calls; with `timed` the device is synchronised before and after each
    collective, so that "seconds" holds the collectives' own time and no
    earlier kernel's (a measurement setting: the loop otherwise makes no
    host sync for them beyond what the backend does)."""

    group: object
    rank: int
    size: int
    device: torch.device
    timed: bool = False
    stats: dict = field(default_factory=lambda: {"calls": 0, "bytes_in": 0, "seconds": 0.0})

    def __post_init__(self):
        if self.size < 1 or self.size & (self.size - 1):
            raise ValueError(f"a particle group needs a power-of-two size, got {self.size}")

    @property
    def particle_map(self) -> tuple:
        """(offset, stride): local particle j is global particle offset + stride j."""
        return self.rank, self.size

    def local_count(self, n: int) -> int:
        """Particles of a run this rank holds, of n; n must divide evenly."""
        if n % self.size:
            raise ValueError(f"{n} particles do not divide over {self.size} ranks")
        return n // self.size

    def local_indices(self, n: int, device=None) -> torch.Tensor:
        """The global indices (n_local,) of this rank's particles, of n."""
        self.local_count(n)
        return torch.arange(self.rank, n, self.size, dtype=torch.int64,
                            device=self.device if device is None else device)

    def take_shard(self, v: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's rows of a global tensor along `dim` (contiguous)."""
        self.local_count(v.shape[dim])
        idx = [slice(None)] * v.dim()
        idx[dim] = slice(self.rank, None, self.size)
        return v[tuple(idx)].contiguous()

    # ---- collectives

    def _check(self, t: torch.Tensor):
        if t.device.type != self.device.type:
            raise ValueError(
                f"a {t.device.type} tensor handed to a particle group on "
                f"{self.device}: move it there first (no collective is moved "
                "between devices behind the caller's back)")

    def _timed(self, fn, nbytes: int):
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["seconds"] += time.perf_counter() - t0
        self.stats["calls"] += 1
        self.stats["bytes_in"] += nbytes
        return out

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's `t` (same shape on every rank), in rank order."""
        self._check(t)
        src = t.contiguous()
        wire = src.to(torch.uint8) if src.dtype == torch.bool else src
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        nbytes = wire.numel() * wire.element_size() * (self.size - 1)
        self._timed(lambda: dist.all_gather(parts, wire, group=self.group), nbytes)
        if src.dtype == torch.bool:
            parts = [p.to(torch.bool) for p in parts]
        return parts

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of every rank's `t`: exact."""
        self._check(t)
        out = t.contiguous().clone()
        nbytes = out.numel() * out.element_size() * (self.size - 1)
        self._timed(lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX,
                                            group=self.group), nbytes)
        return out

    def all_to_all(self, t: torch.Tensor, send_counts=None, recv_counts=None) -> torch.Tensor:
        """Rows of `t` (along dim 0) sent to every rank in rank order,
        send_counts[p] rows to rank p (None: equal parts); returns the rows
        received, recv_counts[p] from rank p, in rank order."""
        self._check(t)
        src = t.contiguous()
        rows = src.shape[0] if recv_counts is None else sum(recv_counts)
        out = src.new_empty((rows,) + tuple(src.shape[1:]))
        mine = rows // self.size if recv_counts is None else recv_counts[self.rank]
        nbytes = (rows - mine) * (out[:1].numel() * out.element_size())
        self._timed(lambda: dist.all_to_all_single(out, src, recv_counts, send_counts,
                                                   group=self.group), nbytes)
        return out

    def barrier(self):
        dist.barrier(group=self.group)


def particle_group(group=None, device=None) -> ParticleGroup:
    """The ParticleGroup of an initialised process group (None: the default
    group, e.g. the one `parallel.multihost.initialize` or torchrun set up).

    The device defaults to the backend's: `cuda:{LOCAL_RANK}` under NCCL,
    the CPU under gloo. A CUDA device under gloo must be named (several
    ranks sharing a card); a CPU device under NCCL raises."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.multihost.initialize() (or run under torchrun)")
    backend = dist.get_backend(group)
    if device is None:
        device = (f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if backend == "nccl"
                  else "cpu")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group works on CUDA tensors, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but no CUDA device is available")
    return ParticleGroup(group, dist.get_rank(group), dist.get_world_size(group), device)


def shard_group(pg: ParticleGroup, ranks) -> ParticleGroup | None:
    """A ParticleGroup over the ranks `ranks` of pg's group (every rank of
    pg must call this, in the same order, as `torch.distributed.new_group`
    requires); None on a rank outside them."""
    ranks = list(ranks)
    sub = dist.new_group(ranks)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return ParticleGroup(sub, ranks.index(me), len(ranks), pg.device, pg.timed)


# ---- the collectives the SMC ops use (their code lives in `ops`)


def group_row_sum(v: torch.Tensor, group: ParticleGroup | None = None) -> torch.Tensor:
    """The sum over the global particle axis (the last) of the sharded v,
    equal to the bit to `row_sum` of the unsharded vector."""
    return row_sum(v, group)


def gather_result(result, group: ParticleGroup | None):
    """An SMCResult of a sharded run with its per-particle fields (x_final,
    logw_final, x_saved, logw_saved) gathered into the global particle
    order on every rank; the other fields are the same on every rank
    already."""
    if group is None:
        return result
    fields = result._asdict()
    for name, dim in (("x_final", -2), ("logw_final", -1), ("x_saved", -2),
                      ("logw_saved", -1)):
        if fields[name] is not None:
            fields[name] = gather_particles(fields[name], group, dim=dim)
    return type(result)(**fields)
