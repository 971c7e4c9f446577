"""ESS-based adaptive tempering, per run.

The reference finds the next temperature by bisecting ESS(phi) - alpha N on
[phi_old, 1] (reference smcnuts/tempering/adaptive_tempering.py:38-63). With
logp(x, phi) = logprior + phi loglik the objective is a function of one
log-likelihood vector,

    logw(phi) = (phi - phi_old) loglik(x),

so the search is a fixed number of bisection steps of tensor ops: no host
sync, and every run of a batch (loglik (B, N), phi_old (B,)) bisects its own
interval. As the reference does, it returns exactly 1.0 when ESS(1.0) already
meets the target. Every ESS goes through `ops.weights` and so through the
fixed-order sums of `ops.reduce`; with a particle group (loglik the rank's
shard) the sums run over the ranks, and every rank takes the same phi, the
unsharded one to the bit.
"""

from __future__ import annotations

import torch

from .weights import ess as _ess
from .weights import normalise_weights

BISECT_ITERS = 50  # interval width 2^-50, below scipy's default xtol


def ess_at_phi(loglik, phi, phi_old, group=None):
    """ESS of the incremental weights moving phi_old -> phi; loglik (..., N),
    phi and phi_old of its leading shape."""
    wn, _ = normalise_weights((phi - phi_old)[..., None] * loglik, group)
    return _ess(wn, group)


def next_temperature(loglik, phi_old, n_particles, alpha=0.5, iters=BISECT_ITERS,
                     group=None):
    """The next temperature in (phi_old, 1] by ESS-thresholded bisection.

    loglik: (..., N) untempered log-likelihood at the particles' positions;
    phi_old: a number or a tensor of loglik's leading shape; n_particles the
    global N."""
    target = n_particles * alpha
    one = torch.ones(loglik.shape[:-1], dtype=loglik.dtype, device=loglik.device)
    a = torch.as_tensor(phi_old, dtype=loglik.dtype, device=loglik.device) * one
    phi_old, b = a, one
    for _ in range(iters):
        m = 0.5 * (a + b)
        # The root of an objective that decreases in phi: keep the half with
        # the sign change, f(a) >= 0 > f(b).
        keep_right = ess_at_phi(loglik, m, phi_old, group) - target >= 0
        a, b = torch.where(keep_right, m, a), torch.where(keep_right, b, m)
    met_at_one = ess_at_phi(loglik, one, phi_old, group) - target >= 0
    return torch.where(met_at_one, one, 0.5 * (a + b))
