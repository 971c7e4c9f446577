"""Eight-schools hierarchical model, non-centred (Rubin 1981; the data used
across Stan's documentation).

Unconstrained parameters x = [mu, log_tau, tt_1..tt_J] (D = 2 + J, J = 8):
    mu ~ N(0, 5); tau ~ HalfCauchy(0, 5) with the exp transform (+ log_tau
    Jacobian); tt_j ~ N(0, 1); y_j ~ N(mu + tau tt_j, sigma_j).
Constrained output: [mu, tau, theta_1..theta_J], theta_j = mu + tau tt_j.

`make_eightschools_generated()` is the same density written as a user would
write it, per particle in torch ops (`CallableModel`): gradients by autograd
on the eager backend and, inside the CUDA kernel, by the generated
reverse-mode model of `ops/generated.tile_model_from_logp`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.generated import tile_model_from_logp
from .base import LOG_SQRT_2PI, CallableModel, cauchy_lpdf, normal_lpdf

Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

LOG_5 = math.log(5.0)
# The constants of logp_and_grad, named as in csrc/eightschools_model.cuh.
MU_CONST = LOG_5 + LOG_SQRT_2PI  # of N(0, 5) on mu
TAU_CONST = -math.log(math.pi) - LOG_5  # of Cauchy(0, 5) on tau
LOG_2 = math.log(2.0)
INV_5 = 0.2


class EightSchoolsModel(nn.Module):
    """`y` and `sigma` (J,) are float64 buffers that follow `.to(device)`;
    in float32 the model works on them rounded to float32, and on the log of
    the rounded sigma, as the JAX tile model does."""

    name = "eightschools"
    # `chip_smoke.py` timed the single kernel and six split tuples at 51,200
    # lanes (step 0.2, depth 6) on an NVIDIA H100, 700 W: none was faster than
    # the single kernel (0.355 ms; the tuples 0.387-0.525 ms). No hint.
    compaction_hint = ()
    compaction_hint_adapted = ()

    def __init__(self, y=None, sigma=None):
        super().__init__()
        y = np.asarray(Y if y is None else y, dtype=np.float64)
        sigma = np.asarray(SIGMA if sigma is None else sigma, dtype=np.float64)
        self.n_schools = int(y.shape[0])
        self.dim = self.constrained_dim = 2 + self.n_schools
        self.param_names = ("mu", "tau") + tuple(
            f"theta.{j + 1}" for j in range(self.n_schools))
        self.register_buffer("y", torch.as_tensor(y))
        self.register_buffer("sigma", torch.as_tensor(sigma))
        self.register_buffer("log_sigma", torch.as_tensor(np.log(sigma)))
        self.register_buffer("log_sigma_f32", torch.as_tensor(
            np.log(sigma.astype(np.float32).astype(np.float64)).astype(np.float32)))

    def _data(self, dtype):
        log_sigma = self.log_sigma_f32 if dtype == torch.float32 else self.log_sigma
        return self.y.to(dtype), self.sigma.to(dtype), log_sigma.to(dtype)

    def logprior(self, x):
        mu, log_tau, tt = x[:, 0], x[:, 1], x[:, 2:]
        tau = torch.exp(log_tau)
        lp = normal_lpdf(mu, 0.0, 5.0)
        # Half-Cauchy on tau: the Cauchy density + log 2 for the folding,
        # plus the exp transform's Jacobian.
        lp = lp + cauchy_lpdf(tau, 0.0, 5.0) + LOG_2 + log_tau
        return lp + torch.sum(normal_lpdf(tt, 0.0, 1.0), dim=1)

    def loglik(self, x):
        y, sigma, _ = self._data(x.dtype)
        mu, tau, tt = x[:, 0:1], torch.exp(x[:, 1:2]), x[:, 2:]
        return torch.sum(normal_lpdf(y, mu + tau * tt, sigma), dim=1)

    def logp(self, x, phi=1.0):
        return self.logprior(x) + phi * self.loglik(x)

    def logp_and_grad(self, x, phi=1.0):
        """Tempered logp and its gradient in closed form, written op for op
        as the kernel's device function (`csrc/eightschools_model.cuh`) and
        in the order of the JAX tile density: the priors on mu and tau, then
        per school j in sequence lp -= (0.5 tt_j) tt_j + c and
        ll -= (0.5 z_j) z_j + log sigma_j + c with
        z_j = ((y_j - mu) - tau tt_j) / sigma_j. A division by 5 is a
        multiplication by 0.2 on both sides. A large log_tau overflows tau and
        gives lp = -inf, which the tree's divergence guard handles."""
        y, sigma, log_sigma = self._data(x.dtype)
        J = self.n_schools
        mu, log_tau, tt = x[:, 0], x[:, 1], x[:, 2:]
        tau = torch.exp(log_tau)
        zmu = mu * INV_5
        lp = (-0.5 * zmu) * zmu - MU_CONST
        zt = tau * INV_5
        zt2 = zt * zt
        lp = lp + ((((TAU_CONST - torch.log1p(zt2)) + LOG_2) + log_tau))
        g_mu_lp = -zmu * INV_5
        g_lt_lp = 1.0 - (2.0 * zt2) / (1.0 + zt2)

        z = ((y - mu[:, None]) - tau[:, None] * tt) / sigma  # (P, J)
        zs = z / sigma
        q_tt = (0.5 * tt) * tt
        q_z = (0.5 * z) * z
        lt_term = zs * (tau[:, None] * tt)
        ll = mu * 0.0
        g_mu_ll = mu * 0.0
        g_lt_ll = mu * 0.0
        for j in range(J):
            lp = (lp - q_tt[:, j]) - LOG_SQRT_2PI
            ll = ((ll - q_z[:, j]) - log_sigma[j]) - LOG_SQRT_2PI
            g_mu_ll = g_mu_ll + zs[:, j]
            g_lt_ll = g_lt_ll + lt_term[:, j]
        phi_col = phi[:, None] if isinstance(phi, torch.Tensor) else phi
        grad = torch.cat([
            (g_mu_lp + phi * g_mu_ll)[:, None],
            (g_lt_lp + phi * g_lt_ll)[:, None],
            -tt + phi_col * (zs * tau[:, None]),
        ], dim=1)
        return lp + phi * ll, grad

    def constrain(self, x):
        mu, tau = x[:, 0:1], torch.exp(x[:, 1:2])
        return torch.cat([mu, tau, mu + tau * x[:, 2:]], dim=1)

    def kernel_data(self):
        """The block of floats the CUDA kernel stages: y, sigma, log sigma."""
        return torch.cat([
            self.y.to(torch.float32), self.sigma.to(torch.float32),
            self.log_sigma_f32,
        ])

    def kernel_scalars(self) -> tuple:
        return ()


def make_eightschools(y=None, sigma=None) -> EightSchoolsModel:
    return EightSchoolsModel(y, sigma)


def eightschools_logprior(theta):
    """log p(mu, log_tau, tt) of one particle (D,), with the exp transform's
    Jacobian: the JAX density's prior (`smcnuts_tpu/models/eightschools.py`)."""
    mu, log_tau, tt = theta[0], theta[1], theta[2:]
    lp = normal_lpdf(mu, 0.0, 5.0)
    lp = lp + cauchy_lpdf(torch.exp(log_tau), 0.0, 5.0) + LOG_2 + log_tau
    return lp + torch.sum(normal_lpdf(tt, 0.0, 1.0))


def eightschools_loglik(y=None, sigma=None):
    """loglik(theta) of one particle: y_j ~ N(mu + tau tt_j, sigma_j). The
    data are tensors made on theta's device."""
    y = [float(v) for v in (Y if y is None else y)]
    sigma = [float(v) for v in (SIGMA if sigma is None else sigma)]

    def loglik(theta):
        mu, tau, tt = theta[0], torch.exp(theta[1]), theta[2:]
        return torch.sum(normal_lpdf(theta.new_tensor(y), mu + tau * tt,
                                     theta.new_tensor(sigma)))

    return loglik


def make_eightschools_generated(y=None, sigma=None) -> CallableModel:
    """Eight schools as a per-particle torch density with its generated
    reverse-mode in-kernel model."""
    loglik = eightschools_loglik(y, sigma)
    dim = 2 + len(Y if y is None else y)

    def constrain(theta):
        tau = torch.exp(theta[1:2])
        return torch.cat([theta[:1], tau, theta[0] + tau * theta[2:]])

    def logp(theta, phi):
        return eightschools_logprior(theta) + phi * loglik(theta)

    return CallableModel(
        "eightschools", dim, eightschools_logprior, loglik, constrain=constrain,
        param_names=("mu", "tau") + tuple(f"theta.{j + 1}" for j in range(dim - 2)),
        tile_model=tile_model_from_logp(logp, dim, name="eightschools"),
    )
