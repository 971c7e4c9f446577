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

import copy
import math

import numpy as np
import torch
from torch import nn

from ..ops.generated import tile_model_from_logp
from .base import LOG_SQRT_2PI, CallableModel, cauchy_lpdf, check_group, normal_lpdf

Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

LOG_5 = math.log(5.0)
# The constants of logp_and_grad, named as in csrc/eightschools_model.cuh.
MU_CONST = LOG_5 + LOG_SQRT_2PI  # of N(0, 5) on mu
TAU_CONST = -math.log(math.pi) - LOG_5  # of Cauchy(0, 5) on tau
LOG_2 = math.log(2.0)
INV_5 = 0.2

# Lanes that evaluate one particle in the CUDA kernel (kSchoolsGroup of
# csrc/nuts_tree.cu, four schools a lane; ops/nuts_cuda.py checks the two
# agree): the order in which logp_and_grad sums the schools by default.
# Threads a block of the eight-schools kernel (kSchoolsBlock), and the blocks
# of it an H100 SM holds at once; ops/nuts_cuda.py checks both against the
# built kernel before it launches it, since the compaction threshold below
# rests on them.
GROUP = 2
BLOCK = 64
BLOCKS_PER_SM = 5


class EightSchoolsModel(nn.Module):
    """`y` and `sigma` (J,) are float64 buffers that follow `.to(device)`;
    in float32 the model works on them rounded to float32, and on the log of
    the rounded sigma, as the JAX tile model does."""

    name = "eightschools"
    # `chip_smoke.py` phase 8 timed the group kernel's single dispatch and six
    # split tuples at 51,200 lanes (100 x 512, step 0.2, depth 6: the settings
    # of phase 9's eight-schools run) on an NVIDIA H100 80GB HBM3, 700 W, the
    # device alone: a split after doubling 3 took 0.2515 / 0.2518 ms against
    # the single kernel's 0.2577-0.2587, the fastest in two runs; the other
    # tuples 0.2912-0.3204. (The one-thread-a-tree kernel before it gained
    # from no split: 0.355 ms single, the tuples 0.387-0.525.) No adapted run
    # was measured: no adapted hint.
    compaction_hint = (3,)
    compaction_hint_adapted = ()
    # A hint pays only past the trees the card holds at once in the
    # eight-schools kernel, counted in its blocks: the H100's 132 SMs x
    # BLOCKS_PER_SM blocks x BLOCK / GROUP trees a block.
    compaction_min_lanes = 132 * BLOCKS_PER_SM * (BLOCK // GROUP)
    group = GROUP  # the group order of logp_and_grad's default (at_group)

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

    def logp_and_grad(self, x, phi=1.0, group=None):
        """Tempered logp and its gradient in closed form, written op for op
        as the kernel's device function (`csrc/eightschools_model.cuh`) at
        group width W = `group` (None: the model's, `GROUP` unless `at_group`
        set another), so the two round alike. The priors on mu and tau give
        lp0; per school j, the terms of the JAX tile density:
        (0.5 tt_j) tt_j + c of the prior, (0.5 z_j) z_j + log sigma_j + c of
        the likelihood with z_j = ((y_j - mu) - tau tt_j) / sigma_j, and
        zs_j = z_j / sigma_j for the gradient. Lane l of W takes schools
        l, l + W, ... in that order on four partials (the tt prior, ll,
        sum zs_j, sum zs_j (tau tt_j)), every one from zero (mu * 0) except
        the tt prior's at W = 1, which starts from lp0: W = 1 is the
        sequential order of the JAX tile density. At W > 1 the partials are
        reduced by the kernel's xor butterfly, v = v + v[lane ^ o] for
        o = W/2, ..., 1, lane 0's sums are taken and lp = lp0 + the tt
        prior's. A division by 5 is a multiplication by 0.2 on both sides. A
        large log_tau overflows tau and gives lp = -inf, which the tree's
        divergence guard handles. No reduction op: its summation order
        differs from the kernel's."""
        W = check_group(self.group if group is None else group)
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
        # Lane l's partials in column l: the tt prior, ll, sum zs, sum lt_term.
        zero = (mu * 0.0)[:, None].expand(-1, W)
        pt = lp[:, None].expand(-1, W) if W == 1 else zero
        ll, g_mu_ll, g_lt_ll = zero, zero, zero
        for lo in range(0, J, W):
            n = min(W, J - lo)  # lanes that have school lo + l

            def step(acc, new):
                return torch.cat([new, acc[:, n:]], dim=1)

            cols = slice(lo, lo + n)
            pt = step(pt, (pt[:, :n] - q_tt[:, cols]) - LOG_SQRT_2PI)
            ll = step(ll, ((ll[:, :n] - q_z[:, cols]) - log_sigma[cols]) - LOG_SQRT_2PI)
            g_mu_ll = step(g_mu_ll, g_mu_ll[:, :n] + zs[:, cols])
            g_lt_ll = step(g_lt_ll, g_lt_ll[:, :n] + lt_term[:, cols])
        lanes = torch.arange(W, device=x.device)
        o = W // 2
        while o:
            pt, ll, g_mu_ll, g_lt_ll = (v + v[:, lanes ^ o] for v in (pt, ll, g_mu_ll, g_lt_ll))
            o //= 2
        pt, ll, g_mu_ll, g_lt_ll = pt[:, 0], ll[:, 0], g_mu_ll[:, 0], g_lt_ll[:, 0]
        lp = pt if W == 1 else lp + pt
        phi_col = phi[:, None] if isinstance(phi, torch.Tensor) else phi
        grad = torch.cat([
            (g_mu_lp + phi * g_mu_ll)[:, None],
            (g_lt_lp + phi * g_lt_ll)[:, None],
            -tt + phi_col * (zs * tau[:, None]),
        ], dim=1)
        return lp + phi * ll, grad

    def at_group(self, group):
        """The same model (its buffers shared) whose `logp_and_grad` sums at
        group width `group` by default: the plain version, for
        `ops.nuts_cuda.nuts_tree_plain` or the eager SMC loop, of a kernel
        entry of that width (`ops.nuts_cuda.nuts_tree_variant`). The main
        kernel runs GROUP lanes only and refuses another width."""
        view = copy.copy(self)
        view.group = check_group(group)
        return view

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


def make_eightschools_generated(y=None, sigma=None, group=None) -> CallableModel:
    """Eight schools as a per-particle torch density with its generated
    reverse-mode in-kernel model (`tile_model_from_logp`'s `group`: None or
    1 the straight-line program, one thread a particle; 2 its sums over the
    schools split over 2 lanes a particle)."""
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
        tile_model=tile_model_from_logp(logp, dim, name="eightschools", group=group),
    )
