"""Analytically tractable Gaussian target: closed-form posterior moments at
every temperature, for golden-value checks of tempering and of all three
L-kernel strategies.

Target N(mean, diag(var)). With `prior_var` the density is split into a prior
N(0, diag(prior_var)) and the "likelihood" that makes prior + likelihood the
target, so logp(x, phi) = (1 - phi) logprior + phi log target is Gaussian at
every phi (`tempered_moments`). Without it the whole density is the prior and
loglik = 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .base import LOG_SQRT_2PI

# Threads a block of the Gaussian's CUDA entries (kGaussianBlock of
# csrc/nuts_tree.cu; the library load checks it): the pipelined walk keeps
# each thread's checkpoint stack in shared memory, 28,160 bytes a block at
# D = 5.
BLOCK = 64


def _log_norm_const(var: np.ndarray) -> float:
    """-0.5 sum log var - D log sqrt(2 pi), in var's own precision as the JAX
    tile model computes it."""
    return float(-0.5 * float(np.sum(np.log(var))) - var.shape[0] * LOG_SQRT_2PI)


class GaussianModel(nn.Module):
    """`mean`, `var` and `prior_var` (when given) are float64 buffers that
    follow `.to(device)`; in float32 the model works on them rounded to
    float32."""

    name = "gaussian"
    # `chip_smoke.py` phase 8 timed the single kernel (the pipelined walk)
    # and six split tuples at 51,200 lanes (100 x 512, D = 3, step 0.5,
    # depth 5) on an NVIDIA H100, 700 W: the single kernel was the fastest
    # (0.0361 and 0.0359 ms; the best split, after doubling 2, 0.0385 ms).
    # No hint.
    compaction_hint = ()
    compaction_hint_adapted = ()

    def __init__(self, mean, var, prior_var=None):
        super().__init__()
        mean = np.asarray(mean, dtype=np.float64)
        var = np.asarray(var, dtype=np.float64)
        self.dim = self.constrained_dim = int(mean.shape[0])
        self.param_names = tuple(f"x{i}" for i in range(self.dim))
        self.has_prior = prior_var is not None
        self.register_buffer("mean", torch.as_tensor(mean))
        self.register_buffer("var", torch.as_tensor(var))
        pvar = None
        if self.has_prior:
            pvar = np.broadcast_to(
                np.asarray(prior_var, dtype=np.float64), mean.shape).copy()
            self.register_buffer("prior_var", torch.as_tensor(pvar))
        # Normalising constants per dtype, from the data rounded to it.
        self._consts = {
            getattr(torch, t): (
                _log_norm_const(var.astype(t)),
                _log_norm_const(pvar.astype(t)) if self.has_prior else 0.0,
            )
            for t in ("float32", "float64")
        }

    def _target_logpdf(self, x):
        mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
        z2 = (x - mean) ** 2 / var
        return torch.sum(-0.5 * z2 - 0.5 * torch.log(var), dim=1) - (
            self.dim * LOG_SQRT_2PI)

    def logprior(self, x):
        if not self.has_prior:
            return self._target_logpdf(x)
        pvar = self.prior_var.to(x.dtype)
        z2 = x ** 2 / pvar
        return torch.sum(-0.5 * z2 - 0.5 * torch.log(pvar), dim=1) - (
            self.dim * LOG_SQRT_2PI)

    def loglik(self, x):
        if not self.has_prior:
            return torch.zeros_like(x[:, 0])
        return self._target_logpdf(x) - self.logprior(x)

    def logp(self, x, phi=1.0):
        return self.logprior(x) + phi * self.loglik(x)

    def logp_and_grad(self, x, phi=1.0):
        """Tempered logp and its gradient in closed form, written op for op
        as the kernel's device function (`csrc/gaussian_model.cuh`) and in the
        order of the JAX tile density: lt = sum_d -((0.5 dx) dx) / var_d in
        sequence, + const_t; with a prior lp alike and lp + phi (lt - lp).
        The divisors are tensors, so every division is a true division on
        every device."""
        mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
        const_t, const_p = self._consts[x.dtype]
        phi_col = phi[:, None] if isinstance(phi, torch.Tensor) else phi
        dx = x - mean
        qt = ((0.5 * dx) * dx) / var
        glt = -dx / var
        lt = x[:, 0] * 0.0
        for d in range(self.dim):
            lt = lt - qt[:, d]
        lt = lt + const_t
        if not self.has_prior:
            return lt + phi * 0.0, glt
        pvar = self.prior_var.to(x.dtype)
        qp = ((0.5 * x) * x) / pvar
        glp = -x / pvar
        lp = x[:, 0] * 0.0
        for d in range(self.dim):
            lp = lp - qp[:, d]
        lp = lp + const_p
        return lp + phi * (lt - lp), glp + phi_col * (glt - glp)

    def constrain(self, x):
        return x

    def kernel_data(self):
        """The block of floats the CUDA kernel stages: mean, var and, with a
        prior, prior_var."""
        parts = [self.mean, self.var] + ([self.prior_var] if self.has_prior else [])
        return torch.cat(parts).to(torch.float32)

    def kernel_scalars(self) -> tuple:
        """const_t, const_p and the has-prior flag, as the kernel takes them."""
        const_t, const_p = self._consts[torch.float32]
        return (const_t, const_p, 1.0 if self.has_prior else 0.0)


def make_gaussian(mean, var, prior_var=None) -> GaussianModel:
    return GaussianModel(mean, var, prior_var)


def tempered_moments(mean, var, prior_var, phi):
    """Mean and variance of exp(logprior + phi loglik): precision
    (1 - phi) / prior_var + phi / var, precision x mean = phi mean / var."""
    mean, var, pvar = map(np.asarray, (mean, var, prior_var))
    prec = (1.0 - phi) / pvar + phi / var
    v = 1.0 / prec
    return v * (phi * mean / var), v
