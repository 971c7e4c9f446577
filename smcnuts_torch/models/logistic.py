"""Bayesian logistic regression.

    beta ~ N(0, prior_scale^2 I)
    y_i ~ Bernoulli(sigmoid(x_i . beta)),  i = 1..n_obs

The default dataset is synthetic with a fixed seed (64 observations x 8
covariates), the same numbers as the JAX package's; pass (X, y) for real
data.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .base import LOG_SQRT_2PI


def _synthetic(n_obs=64, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, dim)).astype(np.float32)
    beta_true = rng.normal(size=(dim,)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    y = (rng.random(n_obs) < p).astype(np.float32)
    return X, y


class LogisticModel(nn.Module):
    """`X` (n_obs, D) and `y` (n_obs,) are float64 buffers holding float32
    values (the data are float32 in the JAX package too); they follow
    `.to(device)`."""

    name = "logistic"
    # `chip_smoke.py` timed the single kernel and six split tuples at 51,200
    # lanes (step 0.1, depth 6) on an NVIDIA H100, 700 W: none was faster than
    # the single kernel (1.40 ms; the tuples 1.47-1.54 ms). No hint.
    compaction_hint = ()
    compaction_hint_adapted = ()

    def __init__(self, X=None, y=None, prior_scale=2.5):
        super().__init__()
        if X is None or y is None:
            X, y = _synthetic()
        X = np.asarray(X, np.float32).astype(np.float64)
        y = np.asarray(y, np.float32).astype(np.float64)
        self.n_obs, self.dim = X.shape
        self.constrained_dim = self.dim
        self.param_names = tuple(f"beta.{d + 1}" for d in range(self.dim))
        self.prior_scale = float(prior_scale)
        # Constants of logp_and_grad, in float64: 1 / prior_scale^2 (a division
        # by a constant is a multiplication by its reciprocal on both sides)
        # and the prior's normalising constant.
        self.inv_ps2 = 1.0 / self.prior_scale ** 2
        self.prior_const = -self.dim * (math.log(self.prior_scale) + LOG_SQRT_2PI)
        self.register_buffer("X", torch.as_tensor(X))
        self.register_buffer("y", torch.as_tensor(y))

    def logprior(self, x):
        ps = self.prior_scale
        return torch.sum(
            -0.5 * (x / ps) ** 2 - math.log(ps) - LOG_SQRT_2PI, dim=1)

    def loglik(self, x):
        X, y = self.X.to(x.dtype), self.y.to(x.dtype)
        eta = x @ X.T
        return torch.sum(y * eta - torch.nn.functional.softplus(eta), dim=1)

    def logp(self, x, phi=1.0):
        return self.logprior(x) + phi * self.loglik(x)

    def logp_and_grad(self, x, phi=1.0):
        """Tempered logp and its gradient in closed form, written op for op
        as the kernel's device function (`csrc/logistic_model.cuh`) and in
        the order of the JAX tile density: eta_i by ordered multiply-adds over
        the covariates; per observation, in sequence,
        ll = (ll + y_i eta_i) - (max(eta_i, 0) + log1p(exp(-|eta_i|))) and
        s_d += (y_i - sigmoid(eta_i)) X_id, on one stacked (P, 1 + D)
        accumulator as PRMwCD's plain version does. The sigmoid is
        1 / (1 + e) for eta >= 0 and e / (1 + e) below, e = exp(-|eta|) <= 1,
        which cannot overflow. No matmul or reduction op."""
        X, y = self.X.to(x.dtype), self.y.to(x.dtype)
        n_obs, D = X.shape
        zero = x[:, 0] * 0.0
        lp = zero
        q = ((0.5 * x) * x) * self.inv_ps2
        for d in range(D):
            lp = lp - q[:, d]
        lp = lp + self.prior_const

        eta = x[:, 0:1] * X[:, 0]  # (P, n_obs)
        for d in range(1, D):
            eta = eta + X[:, d] * x[:, d:d + 1]
        e = torch.exp(-torch.abs(eta))
        softplus = torch.where(eta > 0, eta, torch.zeros_like(eta)) + torch.log1p(e)
        one_e = 1.0 + e
        resid = y - torch.where(eta >= 0, 1.0 / one_e, e / one_e)
        up = torch.cat([(y * eta)[..., None], resid[..., None] * X], dim=2)
        down = torch.cat(
            [softplus[..., None],
             torch.zeros_like(softplus)[..., None].expand(-1, -1, D)], dim=2)
        acc = torch.stack([zero] * (1 + D), dim=1)  # [ll, s_1..s_D]
        for i in range(n_obs):
            acc = (acc + up[:, i]) - down[:, i]
        ll, s = acc[:, 0], acc[:, 1:]
        phi_col = phi[:, None] if isinstance(phi, torch.Tensor) else phi
        return lp + phi * ll, -x * self.inv_ps2 + phi_col * s

    def constrain(self, x):
        return x

    def kernel_data(self):
        """The block of floats the CUDA kernel stages: y, then X row-major."""
        return torch.cat([self.y, self.X.reshape(-1)]).to(torch.float32)

    def kernel_scalars(self) -> tuple:
        """1 / prior_scale^2 and the prior's normalising constant."""
        return (self.inv_ps2, self.prior_const)


def make_logistic(X=None, y=None, prior_scale=2.5) -> LogisticModel:
    return LogisticModel(X, y, prior_scale)
