"""Model protocol: a target density over unconstrained parameters.

    logp(x, phi) = logprior(x) + phi * loglik(x)

Every method is batched over particles: `x` is (N, D) and densities are (N,).
`phi` is a float or an (N,) tensor (one temperature per particle, so runs
with different temperatures can share one call). Densities include Stan's
normalising constants and the log-Jacobian of the constraining transform, as
in the JAX package.

`logp_and_grad` of the hand-written models is written in closed form, not
by autograd: it is the plain version of the model that the CUDA NUTS kernel
inlines. `CallableModel` is the exception: a user's per-particle density,
differentiated by autograd on the eager backend and, with a generated
in-kernel model (`ops/generated.py`), run inside the kernel.

A model also carries its compaction hints, the splits that
`SMCConfig(compaction="auto")` takes for it (`sampler.resolve_compaction`):
`compaction_hint` at a fixed step size and `compaction_hint_adapted` under
step-size adaptation at `ADAPTED_HINT_TARGET`, both used only for dispatches
of more than `compaction_min_lanes` trees (`COMPACTION_MIN_LANES` where the
model names none). An empty hint means the single kernel. The values are
measurements on an NVIDIA H100 (`chip_smoke.py` phase 6b prints them;
PERF.md keeps them). There a stage costs one launch and one pass over the
survivors' carriers, with no sort or gather between stages, so for all three
measured workloads a split after every doubling (`EVERY_DEPTH`) was the
fastest or within 5% of the fastest at 51,200 lanes and the fastest at
204,800; the hints are that tuple.

PRMwCD runs 16 lanes a tree (`models.prmwcd.GROUP`), four trees a block of
64 threads, so `COMPACTION_MIN_LANES`, one block of the one-thread-a-tree
kernel on each SM, does not fit it; its threshold counts its own blocks: the
trees the card holds at once, 132 SMs x 6 blocks x 4 trees = 3,168.
Measured on the group kernel by `chip_smoke.py` phase 6b (NVIDIA H100 80GB
HBM3, 700 W; CUDA events, median of 5, the single kernel timed first and
last), on PRMwCD's population after 100 iterations, first 2 or 5 runs of it,
or tiled: the split after every doubling took 2.2552 ms against the single
kernel's 2.0241 / 2.1141 at 1,024 trees, 2.9491 against 2.5444 / 2.5661 at
2,560, 6.2178 against 6.7163 / 6.8317 at 12,800, 9.7314 against 11.2732 /
11.4381 at 25,600, 16.7790 against 21.0764 / 21.0964 at 51,200 and 59.7035
against 77.8875 / 77.8242 at 204,800, the fastest candidate from 25,600 on
and 0.1% behind the fastest, (7,), at 12,800. Adapted, a split after
doubling 5 took 0.7198 against 0.6651 / 0.6725 at 1,024, 0.8354 against
0.7137 / 0.8363 at 2,560, 1.4552 against 1.6197 / 1.6069 at 12,800 and
2.2936 against 2.6669 / 2.6791 at 25,600 (the fastest at both), 4.5050
against 4.7543 / 4.8164 at 51,200 (0.8% behind the fastest) and 14.4087
against 16.4977 / 16.6990 at 204,800 (2.8% behind a split after every
doubling); a split after every doubling took 1.6758 at 12,800, slower than
the single kernel (the same design in blocks of 128 threads measured
alike). Up to 2,560 trees, all resident at once, staging bought nothing.

arma runs 8 lanes a tree (`models.arma.GROUP`), eight trees a block of 64
threads, 12 blocks an SM: 12,672 trees at once. Its threshold is twice that,
25,344 trees, counted in its own blocks. Measured on the group kernel by
`chip_smoke.py` phase 6b (NVIDIA H100 80GB HBM3, 700 W; the device's time
alone, 20 launches back to back, the single kernel timed first and last), on
arma's population after 100 iterations, tiled: the split after every
doubling took 0.2399 ms against the single kernel's 0.2126 / 0.2130 at
12,800 trees (a split after doubling 3, the best, 0.2147), 0.3155 against
0.3410 / 0.3448 at 25,600 (after doubling 3 alone 0.3112), 0.5070 against
0.6023 / 0.6017 at 51,200 and 1.6243 against 2.1284 / 2.1334 at 204,800 (the
fastest candidate at both); at 1,024 and 2,560 trees nothing staged was
faster.

Logistic regression runs 16 lanes a tree (`models.logistic.GROUP`), four
trees a block of 64 threads, 8 blocks an SM: 4,224 trees at once, its
threshold. Its hint, a split after doubling 2, is the fastest of the split
tuples `chip_smoke.py` phase 8 timed at 51,200 trees (`models/logistic.py`
keeps the numbers).
"""

from __future__ import annotations

import math
from typing import Callable, Protocol, Sequence

import torch
from torch import nn

LOG_SQRT_2PI = float(0.5 * math.log(2.0 * math.pi))
# The target_accept at which every model's adapted hint was measured.
ADAPTED_HINT_TARGET = 0.5
# A hint pays only for dispatches of more lanes (runs x particles) than this,
# unless the model names its own `compaction_min_lanes`: the H100's 132 SMs x
# the NUTS kernel's 128 threads a block, one thread a tree. Up to one block an
# SM no warp waits for another, and a dispatch lasts as long as its deepest
# tree, staged or not (measured at 12,800 lanes; at 25,600 staging gains 5-9%).
COMPACTION_MIN_LANES = 132 * 128
# A split after every doubling below the largest max_tree_depth (10).
EVERY_DEPTH = tuple(range(1, 10))


class Model(Protocol):
    name: str
    dim: int
    constrained_dim: int
    param_names: Sequence[str]
    compaction_hint: tuple
    compaction_hint_adapted: tuple

    def logprior(self, x: torch.Tensor) -> torch.Tensor: ...

    def loglik(self, x: torch.Tensor) -> torch.Tensor: ...

    def logp(self, x: torch.Tensor, phi=1.0) -> torch.Tensor: ...

    def logp_and_grad(
        self, x: torch.Tensor, phi=1.0
    ) -> tuple[torch.Tensor, torch.Tensor]: ...

    def constrain(self, x: torch.Tensor) -> torch.Tensor: ...


class CallableModel(nn.Module):
    """A model from per-particle callables, the port of the JAX package's
    `Model` (`smcnuts_tpu/models/base.py:31-95`).

    `logprior(theta)`, `loglik(theta)` and `constrain(theta)` take one
    particle's unconstrained parameters, a (D,) tensor, and are written in
    torch ops; data they need are Python floats or tensors made on theta's
    device (`theta.new_tensor(values)`), so the model runs on any device and
    in float32 and float64. The batched methods are their `torch.func.vmap`,
    and `logp_and_grad` is `vmap(grad_and_value(logprior + phi * loglik))`:
    autograd, on the eager backend, on the CPU or the card.

    `tile_model`, optional, is a generated in-kernel model of the same
    density (`ops.generated.tile_model_from_logp` or `_fwd`): with it the
    model runs on the CUDA NUTS kernel (float32), and the plain tree takes
    that model's program, the kernel's plain version, in place of autograd.
    Without it `nuts_backend="cuda"` raises. The compaction hints are (), the
    JAX TileModel's default."""

    compaction_hint = ()
    compaction_hint_adapted = ()

    def __init__(self, name: str, dim: int, logprior: Callable, loglik: Callable,
                 constrain: Callable | None = None, constrained_dim: int | None = None,
                 param_names: Sequence[str] | None = None, tile_model=None):
        super().__init__()
        if tile_model is not None and tile_model.dim != dim:
            raise ValueError(f"the tile model has dimension {tile_model.dim}, the "
                             f"model {dim}")
        self.name = name
        self.dim = int(dim)
        self.constrained_dim = self.dim if constrained_dim is None else int(constrained_dim)
        self.param_names = tuple(param_names if param_names is not None else
                                 (f"theta.{i + 1}" for i in range(self.constrained_dim)))
        self._logprior, self._loglik = logprior, loglik
        self._constrain = constrain if constrain is not None else (lambda t: t)
        self.tile_model = tile_model

    def _logp(self, theta, phi):
        return self._logprior(theta) + phi * self._loglik(theta)

    def logprior(self, x):
        return torch.func.vmap(self._logprior)(x)

    def loglik(self, x):
        return torch.func.vmap(self._loglik)(x)

    def logp(self, x, phi=1.0):
        return self.logprior(x) + phi * self.loglik(x)

    def logp_and_grad(self, x, phi=1.0):
        per_particle = isinstance(phi, torch.Tensor) and phi.dim() > 0
        grad, value = torch.func.vmap(
            torch.func.grad_and_value(self._logp), in_dims=(0, 0 if per_particle else None)
        )(x, phi)
        return value, grad

    def constrain(self, x):
        return torch.func.vmap(self._constrain)(x)


def check_group(group) -> int:
    """A group width W (the lanes a hand-written group model runs a particle
    on, and the order its plain version sums in) as an int: a power of two in
    1..32, a group of a warp."""
    W = int(group)
    if W < 1 or W & (W - 1) or W > 32:
        raise ValueError(f"group must be a power of two in 1..32, got {group}")
    return W


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def normal_lpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - _log(sigma) - LOG_SQRT_2PI


def cauchy_lpdf(x, mu, gamma):
    z = (x - mu) / gamma
    return -_log(math.pi * gamma) - torch.log1p(z * z)


def inv_gamma_lpdf(x, alpha, beta):
    return (
        alpha * _log(beta) - math.lgamma(alpha) - (alpha + 1.0) * torch.log(x)
        - beta / x
    )


def poisson_lpmf(y, mu_log):
    """Poisson log-pmf parameterised by the log rate."""
    return y * mu_log - torch.exp(mu_log) - torch.lgamma(y + 1.0)
