"""Initial-sample and momentum proposal distributions.

Any object with `rvs(generator, n)` and a batched `logpdf(x)` can stand in
for a sample proposal (the reference's frozen-scipy duck type); a momentum
proposal also needs `from_normals(eps)`, the draw made from given standard
normals, because the sampler draws those from each run's own stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.base import LOG_SQRT_2PI


@dataclasses.dataclass(frozen=True)
class DiagNormalProposal:
    """N(mean, diag(var)); the default is the standard normal N(0, I)."""

    dim: int
    mean: tuple = None
    var: tuple = None

    def _params(self, dtype, device):
        mean = (
            torch.zeros(self.dim, dtype=dtype, device=device)
            if self.mean is None
            else torch.as_tensor(self.mean, dtype=dtype, device=device)
        )
        var = (
            torch.ones(self.dim, dtype=dtype, device=device)
            if self.var is None
            else torch.as_tensor(self.var, dtype=dtype, device=device)
        )
        return mean, var

    def from_normals(self, eps):
        """mean + eps sqrt(var) for standard normals eps (..., D)."""
        mean, var = self._params(eps.dtype, eps.device)
        return mean + eps * torch.sqrt(var)

    def rvs(self, generator: torch.Generator, n: int, dtype=torch.float32):
        """n draws on the generator's device."""
        return self.from_normals(torch.randn(
            (n, self.dim), generator=generator, dtype=dtype,
            device=generator.device,
        ))

    def logpdf(self, x):
        mean, var = self._params(x.dtype, x.device)
        z2 = (x - mean[None, :]) ** 2 / var[None, :]
        return torch.sum(-0.5 * z2 - 0.5 * torch.log(var)[None, :], dim=1) - (
            self.dim * LOG_SQRT_2PI
        )


@dataclasses.dataclass(frozen=True)
class FullNormalProposal:
    """N(mean, cov) with a dense covariance, the general frozen
    multivariate normal that the reference's experiment script accepts for
    sample and momentum proposals. A draw is mean + L eps with the lower
    Cholesky factor L; the density solves L z = x - mean with one triangular
    solve. L is factored on the host in float64 and rounded to the working
    dtype."""

    mean: tuple
    cov: tuple  # (D, D), symmetric positive definite

    @property
    def dim(self):
        return len(self.mean)

    def _params(self, dtype, device):
        chol = np.linalg.cholesky(np.asarray(self.cov, np.float64))
        return (torch.as_tensor(self.mean, dtype=dtype, device=device),
                torch.as_tensor(chol, dtype=dtype, device=device))

    def from_normals(self, eps):
        """mean + L eps for standard normals eps (..., D); the products are
        summed in sequence over eps's coordinates, so a draw does not depend
        on the shape of the batch it is made in."""
        mean, chol = self._params(eps.dtype, eps.device)
        acc = eps[..., 0:1] * chol[:, 0]
        for j in range(1, self.dim):
            acc = acc + eps[..., j:j + 1] * chol[:, j]
        return mean + acc

    def rvs(self, generator: torch.Generator, n: int, dtype=torch.float32):
        """n draws on the generator's device."""
        return self.from_normals(torch.randn(
            (n, self.dim), generator=generator, dtype=dtype,
            device=generator.device,
        ))

    def logpdf(self, x):
        """log N(x | mean, cov) for x (N, D)."""
        mean, chol = self._params(x.dtype, x.device)
        z = torch.linalg.solve_triangular(chol, (x - mean[None, :]).T, upper=False)
        log_det_half = torch.sum(torch.log(torch.diagonal(chol)))
        return (-0.5 * torch.sum(z * z, dim=0) - log_det_half
                - self.dim * LOG_SQRT_2PI)
