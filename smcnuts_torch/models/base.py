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
of more than `COMPACTION_MIN_LANES` trees. An empty hint means the single
kernel. The values are measurements on an NVIDIA H100 (`chip_smoke.py` phase
6b prints them; PERF.md keeps them). There a stage costs one launch and one
pass over the survivors' carriers, with no sort or gather between stages, so
for all three measured workloads a split after every doubling (`EVERY_DEPTH`)
was the fastest or within 5% of the fastest at 51,200 lanes and the fastest
at 204,800; the hints are that tuple.
"""

from __future__ import annotations

import math
from typing import Callable, Protocol, Sequence

import torch
from torch import nn

LOG_SQRT_2PI = float(0.5 * math.log(2.0 * math.pi))
# The target_accept at which every model's adapted hint was measured.
ADAPTED_HINT_TARGET = 0.5
# A hint pays only for dispatches of more lanes (runs x particles) than this:
# the H100's 132 SMs x the NUTS kernel's 128 threads a block. Up to one block
# an SM no warp waits for another, and a dispatch lasts as long as its deepest
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
