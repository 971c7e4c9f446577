"""Model protocol: a target density over unconstrained parameters.

    logp(x, phi) = logprior(x) + phi * loglik(x)

Every method is batched over particles: `x` is (N, D) and densities are (N,).
`phi` is a float or an (N,) tensor (one temperature per particle, so runs
with different temperatures can share one call). Densities include Stan's
normalising constants and the log-Jacobian of the constraining transform, as
in the JAX package.

`logp_and_grad` is written in closed form, not by autograd: it is the plain
version of the model that the CUDA NUTS kernel inlines.
"""

from __future__ import annotations

import math
from typing import Protocol, Sequence

import torch

LOG_SQRT_2PI = float(0.5 * math.log(2.0 * math.pi))


class Model(Protocol):
    name: str
    dim: int
    constrained_dim: int
    param_names: Sequence[str]

    def logprior(self, x: torch.Tensor) -> torch.Tensor: ...

    def loglik(self, x: torch.Tensor) -> torch.Tensor: ...

    def logp(self, x: torch.Tensor, phi=1.0) -> torch.Tensor: ...

    def logp_and_grad(
        self, x: torch.Tensor, phi=1.0
    ) -> tuple[torch.Tensor, torch.Tensor]: ...

    def constrain(self, x: torch.Tensor) -> torch.Tensor: ...


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
