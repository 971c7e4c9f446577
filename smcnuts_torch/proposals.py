"""Initial-sample proposal distribution.

Any object with `rvs(generator, n)` and a batched `logpdf(x)` can stand in
for it (the reference's frozen-scipy duck type).
"""

from __future__ import annotations

import dataclasses

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

    def is_standard(self) -> bool:
        mean_ok = self.mean is None or not any(self.mean)
        var_ok = self.var is None or all(v == 1.0 for v in self.var)
        return mean_ok and var_ok

    def rvs(self, generator: torch.Generator, n: int, dtype=torch.float32):
        """n draws on the generator's device."""
        mean, var = self._params(dtype, generator.device)
        eps = torch.randn(
            (n, self.dim), generator=generator, dtype=dtype,
            device=generator.device,
        )
        return mean[None, :] + eps * torch.sqrt(var)[None, :]

    def logpdf(self, x):
        mean, var = self._params(x.dtype, x.device)
        z2 = (x - mean[None, :]) ** 2 / var[None, :]
        return torch.sum(-0.5 * z2 - 0.5 * torch.log(var)[None, :], dim=1) - (
            self.dim * LOG_SQRT_2PI
        )
