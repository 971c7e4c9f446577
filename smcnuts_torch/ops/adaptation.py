"""Step-size and mass-matrix adaptation, per run (the JAX package's
`ops/adaptation.py`, with its formulas and defaults).

- Step size: Nesterov dual averaging on the NUTS accept statistic (Hoffman &
  Gelman 2014, Alg. 6), driven by each run's population mean of the per-leaf
  MH ratio that the tree accumulates.
- Mass matrix: the diagonal inverse mass becomes each run's weighted particle
  variance in unconstrained space, smoothed geometrically against the
  previous estimate; on the unfused proposal path the momenta are drawn
  from N(0, M) with M = diag(1 / inverse mass) outside the tree
  (`mass_momentum_rvs`, from standard normals the caller draws) and their
  density enters the weights (`mass_momentum_logpdf`).

Every field and argument has a leading run axis: (B,) scalars, (B, N, D)
particles, (B, D) inverse masses. Sums over particles take the fixed order
of `ops.reduce`, over the ranks of a particle group where one is given.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .moments import weighted_moments


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor  # current log step size
    log_step_avg: torch.Tensor  # averaged iterate (used after warmup)
    h_bar: torch.Tensor  # running error statistic
    mu: torch.Tensor  # shrinkage target log(10 * eps0)
    count: torch.Tensor  # t


def da_init(step_size0: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(step_size0)
    return DualAveragingState(
        log_step=log_eps,
        log_step_avg=log_eps,
        h_bar=torch.zeros_like(step_size0),
        mu=torch.log(10.0 * step_size0),
        count=torch.zeros_like(step_size0),
    )


def da_update(state: DualAveragingState, accept_stat, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    t = state.count + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_stat)
    log_step = state.mu - (torch.sqrt(t) / gamma) * h_bar
    eta_x = t ** (-kappa)
    log_step_avg = eta_x * log_step + (1.0 - eta_x) * state.log_step_avg
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step_avg,
        h_bar=h_bar,
        mu=state.mu,
        count=t,
    )


def mass_matrix_from_particles(x, wn, inv_mass_old, floor=1e-6, damping=0.5,
                               group=None):
    """Diagonal inverse mass from the weighted particle variance, smoothed
    geometrically against the previous estimate (raw importance-weighted
    variances from a mismatched initial proposal can be wildly off; damping
    keeps the feedback loop stable)."""
    _, var = weighted_moments(x, wn, group)
    var = torch.clamp(var, min=floor)
    return torch.exp(
        damping * torch.log(var) + (1.0 - damping) * torch.log(inv_mass_old)
    )


def mass_momentum_rvs(eps, inv_mass):
    """Momenta r ~ N(0, M), M = diag(1 / inv_mass), from standard normals
    eps (B, N, D) and inv_mass (B, D): the distribution whose kinetic energy
    0.5 r^T inv_mass r the NUTS integrator uses."""
    return eps / torch.sqrt(inv_mass)[:, None, :]


def mass_momentum_logpdf(r, inv_mass):
    """log N(r | 0, diag(1 / inv_mass)) for r (B, N, D) and inv_mass (B, D);
    the sums over the D coordinates are taken in sequence."""
    im = inv_mass[:, None, :]
    quad = r[..., 0] * r[..., 0] * im[..., 0]
    for d in range(1, r.shape[-1]):
        quad = quad + r[..., d] * r[..., d] * im[..., d]
    logdet = torch.log(inv_mass[:, 0])
    for d in range(1, inv_mass.shape[-1]):
        logdet = logdet + torch.log(inv_mass[:, d])
    return (-0.5 * quad + (0.5 * logdet)[:, None]
            - 0.5 * r.shape[-1] * math.log(2.0 * math.pi))
